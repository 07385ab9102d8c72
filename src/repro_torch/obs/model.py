"""Analytic HBM-traffic and communication model of the solve phase
(torch twin of ``repro.obs.model``; numpy and host ints only).

Byte counts separate value bytes (they scale with the hierarchy's dtype
width, the ``PrecisionPolicy`` lever) from index bytes (always int32),
the two halves of the paper's bytes-per-nonzero argument.
``obs.trace.attach_model_bytes`` multiplies ``vcycle_traffic``'s
per-cycle total into a solve's ``CycleTally``.  The model reads the
port's ``GAMGSetup`` / ``LevelSetup`` (``a_ell_plan``, ``A0.br``,
``p_ell``, ``r_ell`` under ``restriction="stored"`` else ``pt.rows``,
``coarse_struct``) and evaluates exactly; it carries no device constant.
``dist_cycle_comm`` is the per-rank message model of one distributed
V-cycle (``repro_torch.dist``; its one constant, ``ALPHA_BYTES``, converts
bytes to latency units).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def value_itemsize(dtype) -> int:
    """Bytes per stored value of a dtype or dtype name ('f32' -> 4)."""
    names = {"f64": 8, "f32": 4, "bf16": 2}
    if isinstance(dtype, str) and dtype in names:
        return names[dtype]
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


def _ell_apply_bytes(nbr, kmax, br, bc, itemsize, scalar=False):
    """Modeled HBM bytes of one blocked-ELL apply: ``(values, indices,
    vectors)``.  Values are ``nbr*kmax`` blocks of ``br*bc``; one int32
    index per block (per scalar nonzero in scalar storage); the x gather
    at the no-reuse bound plus the y write."""
    values = nbr * kmax * br * bc * itemsize
    if scalar:
        indices = nbr * kmax * br * bc * 4
        x_gather = nbr * kmax * br * bc * itemsize
    else:
        indices = nbr * kmax * 4
        x_gather = nbr * kmax * bc * itemsize
    y_write = nbr * br * itemsize
    return values, indices, x_gather + y_write


def vcycle_traffic(setupd, itemsize: int = 8, scalar: bool = False) -> dict:
    """Modeled HBM bytes of one V(degree, degree) cycle at a value width:
    per level ``2*degree + 1`` applies of A, ``2*degree`` pbjacobi applies
    of the dinv blocks, one R and one P apply; the dense triangular solves
    at the coarsest level.  Returns ``{"value", "index", "vector",
    "total"}``."""
    degree = setupd.degree
    v = ix = vec = 0
    for ls in setupd.levels:
        nbr, kmax = ls.a_ell_plan.indices.shape
        bs = ls.A0.br
        av, ai, avec = _ell_apply_bytes(nbr, kmax, bs, bs, itemsize, scalar)
        n_apply = 2 * degree + 1
        v += n_apply * av
        ix += n_apply * ai
        vec += n_apply * avec
        # pbjacobi: dinv blocks + r read + x update, per smoothing step
        vec += 2 * degree * 3 * nbr * bs * itemsize
        v += 2 * degree * nbr * bs * bs * itemsize
        pe = ls.p_ell
        pv, pi, pvec = _ell_apply_bytes(pe.nbr, pe.kmax, pe.br, pe.bc,
                                        itemsize, scalar)
        v += pv
        ix += pi
        vec += pvec
        if ls.r_ell is not None:
            re = ls.r_ell
            rv, ri, rvec = _ell_apply_bytes(re.nbr, re.kmax, re.br, re.bc,
                                            itemsize, scalar)
            v += rv
            ix += ri
            vec += rvec
        elif scalar:
            # the scalar baseline stores an expanded restriction: charge
            # the stored-equivalent streams from the plan's dimensions
            nbc_t, tkmax = ls.pt.rows.shape
            rv, ri, rvec = _ell_apply_bytes(nbc_t, tkmax, pe.bc, pe.br,
                                            itemsize, True)
            v += rv
            ix += ri
            vec += rvec
        else:
            # transpose-free restriction: P's payload is charged once by
            # the prolongation; the restriction re-reads the plan's two
            # int32 streams per slot plus the vector gather and write
            nbc_t, tkmax = ls.pt.rows.shape
            ix += 2 * nbc_t * tkmax * 4
            vec += (nbc_t * tkmax * pe.br * itemsize
                    + nbc_t * pe.bc * itemsize)
    nc = setupd.coarse_struct.nbr * setupd.coarse_struct.br
    v += nc * nc * itemsize          # two triangular solves over the factor
    vec += 2 * nc * itemsize
    return {"value": v, "index": ix, "vector": vec,
            "total": v + ix + vec}


def cycle_bytes(setupd) -> float:
    """``vcycle_traffic``'s total at the setup's hierarchy itemsize: the
    modeled bytes of one cycle a counted solve multiplies into its
    ``CycleTally``."""
    itemsize = value_itemsize(setupd.precision.hierarchy_dtype)
    return float(vcycle_traffic(setupd, itemsize=itemsize)["total"])


def hierarchy_storage_bytes(setupd, itemsize: int = 8) -> dict:
    """Device-resident bytes of the solve-phase hierarchy at a value
    width: ``{"operator", "transfer", "coarse", "total"}`` — the level
    operators' ELL payloads, indices and dinv blocks; P and either the
    stored R or the transpose-free plan's streams (rows and gather int32
    plus the bool mask); the dense coarse factor."""
    op = tr = 0
    for ls in setupd.levels:
        nbr, kmax = ls.a_ell_plan.indices.shape
        bs = ls.A0.br
        op += nbr * kmax * (bs * bs * itemsize + 4)     # a_ell data + idx
        op += nbr * bs * bs * itemsize                  # dinv blocks
        pe = ls.p_ell
        tr += pe.nbr * pe.kmax * (pe.br * pe.bc * itemsize + 4)
        if ls.r_ell is not None:
            re = ls.r_ell
            tr += re.nbr * re.kmax * (re.br * re.bc * itemsize + 4)
        else:
            nbc_t, tkmax = ls.pt.rows.shape
            tr += nbc_t * tkmax * (2 * 4 + 1)           # rows+gather+mask
    nc = setupd.coarse_struct.nbr * setupd.coarse_struct.br
    coarse = nc * nc * itemsize
    return {"operator": op, "transfer": tr, "coarse": coarse,
            "total": op + tr + coarse}


#: Rank-local bytes whose streaming time equals one alpha of network
#: latency — the single model constant converting interior-apply work into
#: alpha units for the overlap accounting (order of magnitude: ~1 us of
#: latency over ~64 GB/s of effective local bandwidth; a model constant,
#: not a measured rate of any device).
ALPHA_BYTES = 64 * 1024


def dist_cycle_comm(dg, itemsize: int = 8,
                    alpha_bytes: int = ALPHA_BYTES) -> list:
    """Per-level, per-rank comm model of one distributed V-cycle.

    The latency-vs-bandwidth accounting behind coarse-level agglomeration
    (``repro_torch.dist.solver``; the reference's model, verbatim): every
    halo-window exchange is one *event* whose ppermutes run concurrently
    (one alpha of latency) and move ``exchanged_slabs`` messages; an all-gather is one event of
    ``ceil(log2(ndev))`` alphas (recursive doubling) moving ``ndev - 1``
    slab-messages.  Per sharded level and cycle: ``2*degree + 1`` operator
    applies (degree smoothing each side + the residual) plus one R and one
    P transfer; the sharded coarsest adds the solve-side rhs all-gather.
    A replicated level is one all-gather event at the switch (the boundary
    restriction) and *zero* everywhere else — prolongation back across the
    boundary is communication-free by construction.

    Overlap accounting (the ``REPRO_TORCH_OVERLAP=on`` split apply): each
    window event's latency is charged as ``max(alpha_exchange,
    t_interior)`` — the exchange hides behind the interior rows'
    communication-free work.
    ``t_interior`` is the interior partition's modeled apply bytes (from
    the build-time split counts, the *minimum* over ranks — the rank with
    the least interior work hides the least) converted to alpha units via
    ``alpha_bytes``.  ``latency`` stays the blocking charge (back-compat);
    ``hidden_latency = sum_events min(alpha_event, t_interior)`` is what
    the overlap removes and ``eff_latency = latency - hidden_latency`` is
    what remains on the critical path.

    A 2-D ``ProcessMesh`` (``dg.mesh``) divides each rank's halo traffic
    and interior work by ``pc`` — the column ranks of one row group split
    the slab's boundary-facing streams.

    Returns one dict per level (+ the coarsest):
    ``{level, placement, msgs, latency, hidden_latency, eff_latency,
    halo_bytes, gather_bytes}`` — message count and latency are per rank
    per cycle, bytes split the neighbor-halo traffic from the all-gather
    traffic so benchmarks can report both levers separately.
    """
    ndev = dg.ndev
    pc = dg.mesh.pc if getattr(dg, "mesh", None) is not None else 1
    ag_lat = max(1, math.ceil(math.log2(max(ndev, 2))))
    degree = dg.degree
    rows = []
    ns = len(dg.levels)

    def event_lat(halo):
        """Alphas of one window exchange: ppermutes overlap (1), an
        allgather-fallback window is a full collective (ag_lat)."""
        if not halo.exchanged_slabs:
            return 0
        return ag_lat if halo.strategy == "allgather" else 1

    def interior_alphas(op):
        """Alpha-units of the interior partition's apply work per rank:
        the communication-free compute available to hide one exchange."""
        if op is None or op.int_counts is None or not op.int_counts.size:
            return 0.0
        icnt = int(op.int_counts.min())
        b = (icnt * op.kmax * (op.br * op.bc * itemsize + 4
                               + op.bc * itemsize)
             + icnt * op.br * itemsize)
        return (b / pc) / alpha_bytes

    for li, lv in enumerate(dg.levels):
        n_apply = 2 * degree + 1
        halo = lv.a_op.halo
        vec_bytes = halo.cpad * lv.bs * itemsize        # one exchanged slab
        msgs = n_apply * halo.exchanged_slabs
        lat = n_apply * event_lat(halo)
        hidden = n_apply * min(event_lat(halo), interior_alphas(lv.a_op))
        halo_bytes = msgs * vec_bytes
        gather_bytes = 0
        boundary = li == ns - 1 and dg.repl
        if boundary:
            # restriction crosses the switch: one all-gather of the fine
            # residual slabs; prolongation back is free (replicated halo).
            # The gather feeds a rank-redundant global apply — no interior
            # partition exists to hide it behind.
            msgs += ndev - 1
            lat += ag_lat
            gather_bytes += (ndev - 1) * lv.rpad * lv.bs * itemsize
        else:
            for t in (lv.r_op, lv.p_op):
                t_halo = t.halo
                # the windowed operand's slabs: (cpad, bc-block) vectors
                t_bytes = t_halo.cpad * t.bc * itemsize
                msgs += t_halo.exchanged_slabs
                lat += event_lat(t_halo)
                hidden += min(event_lat(t_halo), interior_alphas(t))
                halo_bytes += t_halo.exchanged_slabs * t_bytes
        rows.append(dict(level=li, placement="sharded", msgs=msgs,
                         latency=lat, hidden_latency=hidden,
                         eff_latency=lat - hidden,
                         halo_bytes=halo_bytes // pc,
                         gather_bytes=gather_bytes))
    for off, rl in enumerate(dg.repl):
        rows.append(dict(level=ns + off, placement="replicated", msgs=0,
                         latency=0, hidden_latency=0.0, eff_latency=0,
                         halo_bytes=0, gather_bytes=0))
    if dg.repl:
        rows.append(dict(level=dg.n_levels, placement="replicated",
                         msgs=0, latency=0, hidden_latency=0.0,
                         eff_latency=0, halo_bytes=0, gather_bytes=0))
    else:
        c = dg.coarse
        rows.append(dict(level=dg.n_levels, placement="sharded",
                         msgs=ndev - 1, latency=ag_lat,
                         hidden_latency=0.0, eff_latency=ag_lat,
                         halo_bytes=0,
                         gather_bytes=(ndev - 1) * c.rpad * c.bs
                         * itemsize))
    return rows
