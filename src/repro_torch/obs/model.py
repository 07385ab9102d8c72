"""Analytic HBM-traffic model of the solve phase (torch twin of the
single-device half of ``repro.obs.model``; numpy and host ints only).

Byte counts separate value bytes (they scale with the hierarchy's dtype
width, the ``PrecisionPolicy`` lever) from index bytes (always int32),
the two halves of the paper's bytes-per-nonzero argument.
``obs.trace.attach_model_bytes`` multiplies ``vcycle_traffic``'s
per-cycle total into a solve's ``CycleTally``.  The model reads the
port's ``GAMGSetup`` / ``LevelSetup`` (``a_ell_plan``, ``A0.br``,
``p_ell``, ``r_ell`` under ``restriction="stored"`` else ``pt.rows``,
``coarse_struct``) and evaluates exactly; it carries no device constant.
"""
from __future__ import annotations

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
