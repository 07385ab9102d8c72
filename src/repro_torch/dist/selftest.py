"""Distributed == single-device selftest (torch twin of
``repro.dist.selftest``).

    python -m repro_torch.dist.selftest <m> --world N --backend gloo|nccl \\
        --device cpu|cuda [--mrhs] [--agg] [--overlap] [--fault] \\
        [--coeff] [--march] [--out F]

starts ``N`` rank processes (``torch.multiprocessing`` spawn; rendezvous
through a ``file://`` store in a temporary directory, so concurrent runs
never share a port), each assembling the ``m^3`` Q1 elasticity problem
and setting GAMG up on its device (``ElasticityConfig``'s greedy
coarsener, ``coarse_size`` 100, the host assembly path, f64); the ranks
hold each other to one setup by digest.  Defaults: the card and the NCCL
backend; without CUDA it raises unless asked for ``--device cpu`` (which
takes ``--backend gloo``).  On the card the parent builds the kernel
library before any rank starts, and every rank runs on card 0: several
ranks share one card through the gloo backend, which stages every halo
payload through host memory (``repro_torch.dist.comm``).  Ranks launch
their kernels untuned (``REPRO_TORCH_TUNE=off``).

Checks (rank 0 holds the run against the port's single-device solve of
the same setup on the same device; any failure on any rank exits
non-zero):

  * the distributed recompute + solve takes the single-device solve's
    iterations, its solution within ``SOLUTION_TOL``, healthy on every
    rank; a second call is bitwise the first; level 0's halo strategy,
    each level's halo widths and the placement are printed;
  * a warm start (``warm_start=True``) on a scaled operator from the cold
    solution takes the single-device warm solve's iterations;
  * the messages and bytes of one V-cycle, counted by ``RankComm`` and
    differenced over the recompute (``repro_torch.dist.measure``), equal
    ``dist_cycle_comm``'s;
  * ``rank0_span`` records the warm solve (built and run with spans on)
    on rank 0 only;
  * ``--mrhs``: a ``--k``-column panel through ``_rank_block_pcg``
    (``block_spmm`` on every slab) takes the single-device panel solve's
    per-column iterations;
  * ``--agg``: the agglomerated placement (``coarse_eq_limit=1<<30``:
    every level above the finest replicated, the tail on the
    single-device kernels) takes the sharded placement's
    (``coarse_eq_limit=0``) iterations;
  * ``--overlap``: ``REPRO_TORCH_OVERLAP=on`` against ``off``: bitwise
    solutions on every rank, equal iterations;
  * ``--fault``: a ``halo:nan`` schedule (at an entry the ranks' boundary
    rows read) is flagged ``nonfinite`` on every rank with a finite
    returned iterate; a clean re-staging afterwards is
    bitwise the unfaulted solve (needs ``--world`` >= 2: a single rank
    has no halo);
  * ``--coeff``: the coefficient program (``make_dist_coeff_solver``:
    two coefficient slabs a rank, the rank assembly on one
    ``block_seg_sum`` launch, the recompute, the solve) on
    ``inclusion_fields`` takes the single-device coefficient solve's
    iterations (``gamg.make_coeff_recompute``, what
    ``GAMGSolver.update_coefficients`` runs, then ``hier_solve``), its
    solution within ``SOLUTION_TOL``, healthy on every rank; each rank's
    assembled slab against ``scatter_fine_payloads`` of the globally
    assembled operator (bitwise, or its largest difference within
    ``SLAB_TOL``), and its x slab bitwise the value-stream program's on
    that operator when the slabs are bitwise (else equal iterations);
    with ``--mrhs`` the panel through it takes the single-device panel's
    and vector solves' per-column iterations; a repeat update from an
    f32 caller stages at the policy dtype and restages no rank operand,
    its host-to-device bytes (``obs.transfer.count_h2d``) the two
    coefficient slabs on the card; with ``--fault`` the ``halo:nan``
    schedule below is flagged ``nonfinite`` on every rank of the
    coefficient program too;
  * ``--march``: ``SofteningScenario.build(prob, rate=0.3)`` for
    ``MARCH_STEPS`` steps through ``make_dist_coeff_solver(...,
    warm_start=True)``, each rank's x slab fed straight back as the next
    x0 slab: per-step iterations equal to ``gamg.make_coeff_solve``'s on
    the same fields, solutions within ``SOLUTION_TOL``, the last warm
    step no more iterations than a cold re-solve, the rank operands
    staged once, and each step's host-to-device bytes (0 on the card:
    the fields are made there);
  * on the card, rank 0 also holds the slab applies (level 0's window
    SpMV and a panel, both Galerkin stages) and, with ``--coeff``, the
    rank assembly's ``block_seg_sum`` on the kernels against their plain
    versions at this run's shapes (``kernel cases``; the rank assembly's
    with its ms, byte bound and ``index_add_``'s ms).

Rank 0 prints a ``dist result {...}`` JSON line (iterations, walls,
messages, kernel launches by family summed over the ranks and counted
around the dist calls only, ...) and ``OK``; ``--out`` also saves it with
the solutions as ``.npz`` (the parity tests read it).
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RTOL, MAXITER = 1e-8, 200
#: the distributed solution against the single-device one, relative to
#: its largest entry (both f64, converged to RTOL in equal iterations)
SOLUTION_TOL = 1e-10
#: a kernel against its plain version, relative to the largest term (f64)
KERNEL_TOL = 1e-12
#: a rank-assembled slab against the global assembly's, relative to its
#: largest entry, when the two differ at all (the card's batched
#: quadrature may round a rank's element batch differently)
SLAB_TOL = 1e-14
#: the warm march: steps and the softening rate
MARCH_STEPS, MARCH_RATE = 3, 0.3
#: the card's memory rate (H100 SXM datasheet), for the byte bound of the
#: rank assembly's kernel case
HBM_BYTES_S = 3.35e12
FAMILIES = ("block_spmv", "block_spmm", "block_pair_gemm", "block_seg_sum",
            "fused_smoother", "fused_pair_gemm", "pbjacobi")


def _ops() -> dict:
    import importlib
    return {f: importlib.import_module(f"repro_torch.kernels.{f}.ops")
            for f in FAMILIES}


class Launches:
    """Kernel launches by family, summed over the calls ``run`` wraps."""

    def __init__(self):
        self.total = dict.fromkeys(FAMILIES, 0)

    def run(self, fn, *args):
        before = {f: m.launches for f, m in _ops().items()}
        out = fn(*args)
        for f, m in _ops().items():
            self.total[f] += m.launches - before[f]
        return out

    def add(self, other: "Launches") -> None:
        for f in FAMILIES:
            self.total[f] += other.total[f]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def _setup_digest(setupd) -> int:
    """A digest of the setup's structures and fixed payloads (what the
    staging is a function of)."""
    h = hashlib.sha256()
    ops = [(ls.A0, ls.P) for ls in setupd.levels]
    for A0, P in ops:
        for a in (A0.indptr, A0.indices, P.indptr, P.indices):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(P.data.detach().cpu().numpy().tobytes())
    h.update(np.ascontiguousarray(setupd.coarse_struct.indices).tobytes())
    return int.from_bytes(h.digest()[:6], "little")   # exact in f64


def _gather(comm, dg, x: torch.Tensor) -> torch.Tensor:
    """Every rank's solution slab -> the global vector, on every rank."""
    g = comm.all_gather_tiled(x)
    return dg.gather_vector(g.reshape((comm.world, -1) + tuple(x.shape[1:])))


def _on_all(comm, value, dev) -> list:
    """``value`` (a number or a 0-d tensor) of every rank, as a list."""
    t = torch.as_tensor(value).reshape(1).to(dev, torch.float64)
    return comm.all_gather(t).reshape(-1).tolist()


def _panel(prob, k: int, dev) -> torch.Tensor:
    """The ``(n, k)`` panel of the panel checks: ``b``, ``b`` mixed with
    noise, then noise."""
    rng = np.random.default_rng(0)
    b_np = prob.b.cpu().numpy()
    cols = [b_np, 0.5 * b_np + rng.standard_normal(prob.n)]
    cols += [rng.standard_normal(prob.n) for _ in range(k - 2)]
    return torch.as_tensor(np.stack(cols[:k], axis=1)).to(dev)


def _assembly_case(da, aargs: dict, E: torch.Tensor, nu: torch.Tensor
                   ) -> dict:
    """Rank 0's rank assembly scatter-sum on ``block_seg_sum`` against its
    plain version, on this run's element blocks: its device ms, the plain
    version's, ``index_add_``'s over the same contributions, and the byte
    bound (each contribution's block and ``perm`` entry read once, the
    offsets read, the slab written, over ``HBM_BYTES_S``)."""
    from repro_torch.fem.device_stiffness import element_value_stream
    from repro_torch.kernels.autotune import device_ms
    from repro_torch.kernels.block_seg_sum import ops as seg_ops
    from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
    vals = element_value_stream(aargs["quad_b"], aargs["quad_w"], E, nu,
                                da.nn)
    bs = da.bs
    perm, offs = aargs["perm"], aargs["offsets"]
    got = seg_ops.block_seg_sum(vals, offs, perm)
    want = block_seg_sum_ref(vals, offs, perm)
    kept = vals[perm.long()]
    slot = torch.repeat_interleave(
        torch.arange(da.a_pad, device=vals.device),
        (offs[1:] - offs[:-1]).long())
    library = torch.zeros_like(got).index_add_(0, slot, kept)
    k = int(perm.numel())
    nbytes = (k * (bs * bs * vals.element_size() + 4) + offs.numel() * 4
              + got.numel() * got.element_size())
    row = dict(name=f"rank assembly block_seg_sum {k}x{bs}x{bs} -> "
                    f"{da.a_pad}",
               shape=list(got.shape), epad=da.epad,
               max_abs_err=float((got - want).abs().max()),
               max_rel_err=_rel(got, want),
               library_rel_err=_rel(library, want),
               ms=device_ms(lambda: seg_ops.block_seg_sum(vals, offs, perm)),
               plain_ms=device_ms(lambda: block_seg_sum_ref(vals, offs,
                                                            perm)),
               library_ms=device_ms(lambda: torch.zeros_like(got)
                                    .index_add_(0, slot, kept)),
               bound_ms=1e3 * nbytes / HBM_BYTES_S, bound_by="bytes",
               bytes=nbytes)
    if row["max_rel_err"] > KERNEL_TOL:
        raise AssertionError(f"dist kernel case {row}")
    return row


def _kernel_cases(dg, args: dict, k: int, dev) -> list:
    """Rank 0's slab applies on the kernels against their plain versions
    at this run's level-0 shapes, on random operands."""
    from repro_torch.dist import pamg
    from repro_torch.kernels.block_pair_gemm.ref import block_pair_gemm_ref
    from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
    from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref
    from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=dev)

    lv, a = dg.levels[0], args["levels"][0]
    op = lv.a_op
    data = randn(op.rpad, op.kmax, op.br, op.bc)
    win = randn(op.halo.window_len, op.bc)
    panel = randn(op.halo.window_len, op.bc, k)
    s1, s2 = lv.stage1, lv.stage2
    bf = a["s1_rhs"].shape[1]
    lhs1 = randn(s1.ppad, bf, bf)
    win2 = randn(s2.halo.window_len, *a["s1_rhs"].shape[1:])
    rhs2 = win2[a["s2_rhs"]]

    def stage_plain(lhs, rhs, off):
        return block_seg_sum_ref(block_pair_gemm_ref(lhs, rhs), off)

    cases = [
        ("a_op window spmv", lambda: pamg.dist_ell_apply(a["a_idx"], data,
                                                         win),
         lambda: block_spmv_ell_ref(a["a_idx"], data, win), None),
        (f"a_op window spmm k={k}",
         lambda: pamg.dist_ell_apply(a["a_idx"], data, panel),
         lambda: block_spmm_ell_ref(a["a_idx"], data, panel), None),
        ("stage1 A@P", lambda: pamg.dist_stage_apply(lhs1, a["s1_rhs"],
                                                     a["s1_off"]),
         lambda: stage_plain(lhs1, a["s1_rhs"], a["s1_off"]), "padded"),
        ("stage2 R@(AP)", lambda: pamg.dist_stage_apply(a["s2_lhs"], rhs2,
                                                        a["s2_off"]),
         lambda: stage_plain(a["s2_lhs"], rhs2, a["s2_off"]), "padded"),
    ]
    out = []
    for name, kern, plain, pad in cases:
        got, want = kern(), plain()
        err = _rel(got, want)
        row = dict(name=name, shape=list(got.shape), max_rel_err=err)
        if pad:
            row["padded_slot_zero"] = bool((got[-1] == 0).all())
        if err > KERNEL_TOL or row.get("padded_slot_zero") is False:
            raise AssertionError(f"dist kernel case {row}")
        out.append(row)
    return out


def _sections(comm, opts, dev) -> dict:
    from repro_torch.core import gamg
    from repro_torch.dist import measure
    from repro_torch.dist.solver import build_dist_gamg, make_dist_solver
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.multirhs.block_krylov import make_block_solve
    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.robust import inject
    from repro_torch.robust.health import HEALTHY, NONFINITE, STATUS_NAMES

    rank, world = comm.rank, comm.world
    lead = rank == 0

    def on_all(value) -> list:
        return _on_all(comm, value, dev)

    say = print if lead else (lambda *a, **k: None)
    res = dict(m=opts.m, world=world, backend=comm.backend,
               device=dev.type)
    arrays = {}
    counted = Launches()

    t0 = time.perf_counter()
    prob = assemble_elasticity(opts.m, path="host", device=dev)
    setupd = gamg.setup(prob.A, prob.B, coarse_size=opts.coarse_size,
                        coarsener=opts.coarsener, precision="f64")
    digests = on_all(_setup_digest(setupd))
    if len(set(digests)) != 1:
        raise AssertionError(f"the ranks built different setups: {digests}")
    res["levels"] = setupd.stats["level_rows"]
    res["setup_s"] = time.perf_counter() - t0

    # the single-device reference on rank 0, same setup, same device
    if lead:
        hier = gamg.recompute(setupd, prob.A.data)
        ref = gamg.hier_solve(setupd, hier, prob.b, rtol=RTOL,
                              maxiter=MAXITER)
        _sync(dev)
        t0 = time.perf_counter()
        gamg.hier_solve(setupd, gamg.recompute(setupd, prob.A.data),
                        prob.b, rtol=RTOL, maxiter=MAXITER)
        _sync(dev)
        res["single_ms"] = 1e3 * (time.perf_counter() - t0)
        res["iters_single"] = ref.iters
        arrays["x_single"] = ref.x

    def stage(limit):
        """Staging at ``limit``, this rank's operands, and the seconds of
        both."""
        t0 = time.perf_counter()
        dg = build_dist_gamg(setupd, world, coarse_eq_limit=limit)
        t1 = time.perf_counter()
        args = dg.rank_args(rank, dev)
        return dg, args, (t1 - t0, time.perf_counter() - t1)

    dg, args, (res["staging_s"], res["rank_args_s"]) = stage(
        opts.coarse_eq_limit)
    a0 = dg.scatter_fine_payloads(prob.A.data, rank)
    b = dg.scatter_vector(prob.b, rank)
    run = make_dist_solver(dg, setupd, comm, rtol=RTOL, maxiter=MAXITER)
    x, iters, relres, ok, status = counted.run(run, args, a0, b)
    _sync(dev)
    t0 = time.perf_counter()
    x2 = counted.run(run, args, a0, b)[0]
    _sync(dev)
    res["wall_ms"] = 1e3 * (time.perf_counter() - t0)
    statuses = on_all(status)
    xg = _gather(comm, dg, x)
    res.update(
        placement=dg.placement, halo=dg.levels[0].a_op.halo.strategy,
        widths=[lv.a_op.halo.width for lv in dg.levels],
        s2_halo=[lv.stage2.halo.strategy for lv in dg.levels],
        iters=iters, relres=float(relres),
        status=[STATUS_NAMES[int(s)] for s in statuses],
        repeat_bitwise=all(v == 1 for v in on_all(torch.equal(x, x2))))
    arrays["x"] = xg
    say(f"ndev={world} m={opts.m} levels={res['levels']} "
        f"halo={res['halo']} widths={res['widths']} "
        f"s2_halo={res['s2_halo']} placement={res['placement']}")
    if any(s != HEALTHY for s in statuses) or not bool(ok):
        raise AssertionError(f"dist solve not healthy: {res['status']}")
    if not res["repeat_bitwise"]:
        raise AssertionError("a repeated dist solve is not bitwise the first")
    if lead:
        res["rel_single"] = _rel(xg, ref.x)
        if iters != ref.iters or res["rel_single"] > SOLUTION_TOL:
            raise AssertionError(
                f"dist vs single-device: iters {iters} vs {ref.iters}, "
                f"rel {res['rel_single']:.3e} (tol {SOLUTION_TOL})")
    say(f"cold solve parity: iters={iters} relres={float(relres):.3e} "
        f"rel_single={res.get('rel_single', 0.0):.3e} "
        f"wall_ms={res['wall_ms']:.1f}")

    # warm start on a scaled operator from the cold solution, under spans:
    # rank0_span records the call on rank 0 only
    a_new = prob.A.data * 1.5
    metrics.reset_default_registry()
    with obs_trace.use("spans"):
        run_w = make_dist_solver(dg, setupd, comm, rtol=RTOL,
                                 maxiter=MAXITER, warm_start=True)
        xw, itw, _, okw, _ = counted.run(
            run_w, args, dg.scatter_fine_payloads(a_new, rank), b, x)
    hist = metrics.default_registry().get("dist/solve/seconds")
    recorded = 0 if hist is None else hist.snapshot()["count"]
    res["span"] = [int(v) for v in on_all(recorded)]
    if res["span"] != [1] + [0] * (world - 1):
        raise AssertionError(f"rank0_span recorded {res['span']}")
    res["warm"] = dict(iters=itw)
    arrays["x_warm"] = _gather(comm, dg, xw)
    if lead:
        hier_new = gamg.recompute(setupd, a_new)
        ref_w = gamg.hier_solve(setupd, hier_new, prob.b, ref.x, rtol=RTOL,
                                maxiter=MAXITER)
        cold_w = gamg.hier_solve(setupd, hier_new, prob.b, rtol=RTOL,
                                 maxiter=MAXITER)
        res["warm"].update(iters_single=ref_w.iters, iters_cold=cold_w.iters,
                           rel_single=_rel(arrays["x_warm"], ref_w.x))
        if itw != ref_w.iters or not bool(okw):
            raise AssertionError(f"warm start: {res['warm']}")
    say(f"warm start parity: {json.dumps(res['warm'])}")

    # messages and bytes of one V-cycle against the model
    overlap = _overlap_on()
    meas = counted.run(measure.measured_cycle_comm, dg, args, a0, b, comm,
                       overlap)
    cmp = measure.compare(dg, meas)
    res["cycle"] = dict(cmp["measured"]["cycle"],
                        model_msgs=cmp["model_msgs"],
                        model_bytes=cmp["model_bytes"], agree=cmp["agree"])
    say(f"cycle messages: {json.dumps(res['cycle'])}")
    if not cmp["agree"]:
        raise AssertionError(f"measured cycle != model: {res['cycle']}")

    if opts.mrhs:
        B = _panel(prob, opts.k, dev)
        xm, itm, _, okm, stm = counted.run(run, args, a0,
                                           dg.scatter_vector(B, rank))
        res["mrhs"] = dict(k=opts.k, iters=itm.tolist())
        arrays["B"], arrays["x_panel"] = B, _gather(comm, dg, xm)
        if lead:
            ref_m = make_block_solve(setupd, rtol=RTOL, maxiter=MAXITER)(
                hier, B)
            res["mrhs"].update(iters_single=ref_m.iters.tolist(),
                               rel_single=_rel(arrays["x_panel"], ref_m.x))
            if res["mrhs"]["iters"] != res["mrhs"]["iters_single"] \
                    or not bool(okm.all()) or bool((stm != HEALTHY).any()):
                raise AssertionError(f"panel: {res['mrhs']}")
        say(f"mrhs (k={opts.k}) parity: {json.dumps(res['mrhs'])}")

    if opts.agg:
        if len(setupd.levels) < 2:
            raise AssertionError(f"--agg needs a mid level: levels "
                                 f"{res['levels']}")
        if dg.repl:
            dg_sh, args_sh, _ = stage(0)
            x_sh, it_sh = counted.run(
                make_dist_solver(dg_sh, setupd, comm, rtol=RTOL,
                                 maxiter=MAXITER), args_sh, a0, b)[:2]
        else:   # the run above already was the fully sharded placement
            x_sh, it_sh = x, iters
        dg_ag, args_ag, _ = stage(1 << 30)
        xa, ita, _, oka, _ = counted.run(
            make_dist_solver(dg_ag, setupd, comm, rtol=RTOL,
                             maxiter=MAXITER), args_ag,
            dg_ag.scatter_fine_payloads(prob.A.data, rank), b)
        arrays["x_agg"] = _gather(comm, dg_ag, xa)
        res["agg"] = dict(placement=dg_ag.placement, iters=ita,
                          iters_sharded=it_sh,
                          rel_sharded=_rel(arrays["x_agg"],
                                           _gather(comm, dg, x_sh)))
        if ita != it_sh or not bool(oka):
            raise AssertionError(f"agglomerated: {res['agg']}")
        say(f"agglomerated parity: {json.dumps(res['agg'])}")

    if opts.overlap:
        def solve_with(mode):
            prev = os.environ.get("REPRO_TORCH_OVERLAP")
            os.environ["REPRO_TORCH_OVERLAP"] = mode
            try:
                run_m = make_dist_solver(dg, setupd, comm, rtol=RTOL,
                                         maxiter=MAXITER)
                return counted.run(run_m, args, a0, b)
            finally:
                if prev is None:
                    os.environ.pop("REPRO_TORCH_OVERLAP")
                else:
                    os.environ["REPRO_TORCH_OVERLAP"] = prev

        # the cold run above took the default schedule
        x_on, it_on = (x, iters) if _overlap_on() else solve_with("on")[:2]
        x_off, it_off = solve_with("off")[:2]
        op0 = dg.levels[0].a_op
        res["overlap"] = dict(
            iters_on=it_on, iters_off=it_off,
            bitwise=all(v == 1 for v in on_all(torch.equal(x_on, x_off))),
            int_rows_min=int(op0.int_counts.min()),
            bnd_rows_max=int(op0.bnd_counts.max()))
        if it_on != it_off or not res["overlap"]["bitwise"]:
            raise AssertionError(f"overlap: {res['overlap']}")
        say(f"overlap solve parity: {json.dumps(res['overlap'])}")

    if opts.fault:
        spec = _halo_fault_spec(dg, b)
        with inject.active(inject.parse_schedule(spec)):
            run_f = make_dist_solver(dg, setupd, comm, rtol=RTOL,
                                     maxiter=MAXITER)
            xf, itf, _, okf, stf = counted.run(run_f, args, a0, b)
        dg_r, args_r, _ = stage(opts.coarse_eq_limit)
        xr = counted.run(
            make_dist_solver(dg_r, setupd, comm, rtol=RTOL,
                             maxiter=MAXITER), args_r,
            dg_r.scatter_fine_payloads(prob.A.data, rank), b)[0]
        fault_status = on_all(stf)
        res["fault"] = dict(
            spec=spec, status=[STATUS_NAMES[int(s)] for s in fault_status],
            iters=itf, converged=bool(okf),
            finite=all(v == 1 for v in on_all(
                bool(torch.isfinite(xf).all()))),
            restage_bitwise=all(v == 1 for v in on_all(
                torch.equal(xr, x))))
        if any(s != NONFINITE for s in fault_status) or bool(okf) \
                or not res["fault"]["finite"] \
                or not res["fault"]["restage_bitwise"]:
            raise AssertionError(f"halo fault: {res['fault']}")
        say(f"halo fault detected: {json.dumps(res['fault'])}")

    assembly = None
    if opts.coeff or opts.march:
        from repro_torch.fem.device_stiffness import DeviceAssembler
        # the selftest assembles on the host path: the coefficient
        # sections assemble on the device through the same COO plan
        prob.assembler = DeviceAssembler.build(prob.mesh, prob.coo_plan, dev)
    if opts.coeff:
        own = Launches()
        res["coeff"], more, assembly = _coeff_section(
            comm, opts, dev, prob, setupd, dg, args, b, run, own)
        counted.add(own)
        arrays.update(more)
        say(f"coefficient hot-loop parity: {json.dumps(res['coeff'])}")
    if opts.march:
        own = Launches()
        res["march"], more = _march_section(comm, dev, prob, setupd, dg,
                                            args, b, own)
        counted.add(own)
        arrays.update(more)
        say(f"dist warm march parity: {json.dumps(res['march'])}")

    if dev.type == "cuda" and lead:
        res["kernel_cases"] = _kernel_cases(dg, args, opts.k, dev)
        if assembly is not None:
            res["kernel_cases"].append(_assembly_case(*assembly))
        for row in res["kernel_cases"]:
            say("dist kernel case " + json.dumps(row))
    res["staged_bytes"] = comm.staged_bytes
    res["launches"] = _summed(comm, counted, dev)
    return res, arrays


def _summed(comm, counted: Launches, dev) -> dict:
    """Launches by family, summed over the ranks."""
    totals = torch.tensor([counted.total[f] for f in FAMILIES],
                          dtype=torch.float64, device=dev)
    summed = comm.all_gather(totals).sum(dim=0)
    return {f: int(v) for f, v in zip(FAMILIES, summed.tolist())}


def _halo_fault_spec(dg, b: torch.Tensor) -> str:
    """A ``halo:nan`` schedule whose NaN lands on the first entry of level
    0's slab ``width`` in its window: the rank's own row 0 under a
    ppermute halo, which every rank with a left neighbour reads on its
    boundary rows (an index is taken modulo each window's size; 0 would
    be a neighbour's far row, which no rank reads)."""
    halo0 = dg.levels[0].a_op.halo
    return (f"halo:nan:index="
            f"{halo0.width * halo0.cpad * int(np.prod(b.shape[1:]))}")


def _all_true(comm, flag, dev) -> bool:
    return all(v == 1 for v in _on_all(comm, bool(flag), dev))


def _coeff_section(comm, opts, dev, prob, setupd, dg, args: dict,
                   b: torch.Tensor, run_v, own: Launches):
    """COEFF: the coefficient program on ``inclusion_fields`` (module
    docstring).  Returns the result, the arrays to save and rank 0's
    rank-assembly operands for its kernel case."""
    from repro_torch.core import gamg
    from repro_torch.dist.solver import _rank_assemble, \
        build_dist_assembly, make_dist_coeff_solver
    from repro_torch.fem.assemble import inclusion_fields
    from repro_torch.multirhs.block_krylov import make_block_solve
    from repro_torch.obs.transfer import count_h2d
    from repro_torch.robust.health import HEALTHY, STATUS_NAMES
    rank, world, lead = comm.rank, comm.world, comm.rank == 0
    asm = prob._device_assembler()
    da = build_dist_assembly(dg, asm)
    aargs = da.rank_args(rank, dev)
    run_c = make_dist_coeff_solver(dg, da, comm, rtol=RTOL, maxiter=MAXITER)
    E_h, nu_h = inclusion_fields(prob.mesh)
    E_r, nu_r = da.scatter_fields(E_h, nu_h, rank, device=dev)
    xc, itc, relc, okc, stc = own.run(run_c, args, aargs, E_r, nu_r, b)
    seg_coeff = own.total["block_seg_sum"]
    _sync(dev)
    t0 = time.perf_counter()
    own.run(run_c, args, aargs, E_r, nu_r, b)
    _sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    statuses = _on_all(comm, stc, dev)
    xg = _gather(comm, dg, xc)

    # the value-stream program on the globally assembled operator
    a_glob = dg.scatter_fine_payloads(
        prob.coefficient_operator(E_h, nu_h).data, rank)
    slab = _rank_assemble(da, aargs, E_r, nu_r)
    seg_before = own.total["block_seg_sum"]
    xv, itv = own.run(run_v, args, a_glob, b)[:2]
    seg_value = own.total["block_seg_sum"] - seg_before
    slab_rel = max(_on_all(comm, _rel(slab, a_glob), dev))
    out = dict(iters=itc, relres=float(relc),
               status=[STATUS_NAMES[int(s)] for s in statuses],
               iters_value=itv,
               slab_bitwise=_all_true(comm, torch.equal(slab, a_glob), dev),
               slab_rel=slab_rel,
               x_bitwise=_all_true(comm, torch.equal(xc, xv), dev),
               assemble_launches=int(sum(_on_all(
                   comm, seg_coeff - seg_value, dev))),
               epad=da.epad, coeff_bytes=2 * da.epad * E_r.element_size(),
               wall_ms=wall_ms)
    arrays = dict(x_coeff=xg)
    if any(s != HEALTHY for s in statuses) or not bool(okc):
        raise AssertionError(f"coefficient solve not healthy: {out}")
    if not (out["x_bitwise"] if out["slab_bitwise"] else
            slab_rel <= SLAB_TOL and itv == itc):
        raise AssertionError(f"coefficient program against the value "
                             f"stream: {out}")

    if lead:
        # GAMGSolver.bind_assembler -> update_coefficients -> solve, on
        # this run's setup: make_coeff_recompute, then hier_solve
        E_d, nu_d = asm.as_fields(E_h, nu_h)
        hier_c = gamg.make_coeff_recompute(setupd, asm)(E_d, nu_d)
        ref_c = gamg.hier_solve(setupd, hier_c, prob.b, rtol=RTOL,
                                maxiter=MAXITER)
        coeff_solve = gamg.make_coeff_solve(setupd, asm, rtol=RTOL,
                                            maxiter=MAXITER)
        zeros = torch.zeros_like(prob.b)
        coeff_solve(E_d, nu_d, prob.b, zeros)
        _sync(dev)
        t0 = time.perf_counter()
        coeff_solve(E_d, nu_d, prob.b, zeros)
        _sync(dev)
        out.update(iters_single=ref_c.iters, rel_single=_rel(xg, ref_c.x),
                   single_ms=1e3 * (time.perf_counter() - t0))
        if itc != ref_c.iters or out["rel_single"] > SOLUTION_TOL:
            raise AssertionError(f"coefficient program against the "
                                 f"single-device solve: {out}")

    if opts.mrhs:
        B = _panel(prob, opts.k, dev)
        xm, itm, _, okm, stm = own.run(run_c, args, aargs, E_r, nu_r,
                                       dg.scatter_vector(B, rank))
        out["mrhs"] = dict(k=opts.k, iters=itm.tolist())
        arrays["x_coeff_panel"] = _gather(comm, dg, xm)
        if lead:
            ref_m = make_block_solve(setupd, rtol=RTOL, maxiter=MAXITER)(
                hier_c, B)
            vec = [gamg.hier_solve(setupd, hier_c, B[:, j].contiguous(),
                                   rtol=RTOL, maxiter=MAXITER).iters
                   for j in range(opts.k)]
            out["mrhs"].update(iters_single=ref_m.iters.tolist(),
                               iters_vector=vec,
                               rel_single=_rel(arrays["x_coeff_panel"],
                                               ref_m.x))
            if not (out["mrhs"]["iters"] == out["mrhs"]["iters_single"]
                    == vec) or not bool(okm.all()) \
                    or bool((stm != HEALTHY).any()):
                raise AssertionError(f"coefficient panel: {out['mrhs']}")

    if opts.fault:
        from repro_torch.robust import inject
        with inject.active(inject.parse_schedule(_halo_fault_spec(dg, b))):
            run_f = make_dist_coeff_solver(dg, da, comm, rtol=RTOL,
                                           maxiter=MAXITER)
            xf, _, _, okf, stf = own.run(run_f, args, aargs, E_r, nu_r, b)
        out["fault"] = dict(
            status=[STATUS_NAMES[int(v)] for v in _on_all(comm, stf, dev)],
            converged=bool(okf),
            finite=_all_true(comm, torch.isfinite(xf).all(), dev))
        if out["fault"]["status"] != ["nonfinite"] * world \
                or bool(okf) or not out["fault"]["finite"]:
            raise AssertionError(f"coefficient program halo fault: {out}")

    # a repeat update from an f32 caller: staged at the policy dtype,
    # no rank operand restaged; its host-to-device bytes are the two
    # coefficient slabs
    staged = da.n_staged
    E32 = np.asarray(E_h, np.float32) * np.float32(1.5)
    (E_f, nu_f), h2d, _ = count_h2d(
        lambda: da.scatter_fields(E32, nu_h, rank, device=dev))
    _, it32, _, ok32, _ = own.run(run_c, args, aargs, E_f, nu_f, b)
    out["f32_update"] = dict(
        dtype=str(E_f.dtype).replace("torch.", ""), iters=it32,
        restaged=int(sum(_on_all(comm, da.n_staged - staged, dev))),
        h2d_bytes=h2d)
    if E_f.dtype != da.stage_dtype or out["f32_update"]["restaged"] \
            or not bool(ok32) or (dev.type == "cuda"
                                  and h2d != out["coeff_bytes"]):
        raise AssertionError(f"f32 coefficient update: {out}")
    out["launches"] = _summed(comm, own, dev)
    return out, arrays, (da, aargs, E_r, nu_r)


def _march_section(comm, dev, prob, setupd, dg, args: dict,
                   b: torch.Tensor, own: Launches):
    """MARCH: the warm coefficient march over the wire (module
    docstring)."""
    from repro_torch.core import gamg
    from repro_torch.dist.solver import build_dist_assembly, \
        make_dist_coeff_solver
    from repro_torch.obs.transfer import count_h2d
    from repro_torch.robust.health import HEALTHY, STATUS_NAMES
    from repro_torch.sim.scenarios import SofteningScenario
    rank, lead = comm.rank, comm.rank == 0
    asm = prob._device_assembler()
    da = build_dist_assembly(dg, asm)
    aargs = da.rank_args(rank, dev)
    run_w = make_dist_coeff_solver(dg, da, comm, rtol=RTOL,
                                   maxiter=MAXITER, warm_start=True)
    coeff_solve = gamg.make_coeff_solve(setupd, asm, rtol=RTOL,
                                        maxiter=MAXITER)
    scen = SofteningScenario.build(prob, rate=MARCH_RATE)
    state = scen.init_state()
    # the fields follow the single-device trajectory (rank 0's solution,
    # sent to every rank), as the reference's march section's do
    x_ref = torch.zeros_like(prob.b)
    x_slab = dg.scatter_vector(x_ref, rank)
    steps, arrays = [], {}
    for s in range(MARCH_STEPS):
        E_s, nu_s, state = scen.step_fields(
            state, x_ref, torch.tensor(s, dtype=torch.int32, device=dev))
        (E_r, nu_r), h2d, _ = count_h2d(
            lambda: da.scatter_fields(E_s, nu_s, rank, device=dev))
        _sync(dev)
        t0 = time.perf_counter()
        x_slab, it, _, ok, st = own.run(run_w, args, aargs, E_r, nu_r, b,
                                        x_slab)
        _sync(dev)
        row = dict(step=s, iters=it, h2d_bytes=h2d,
                   wall_ms=1e3 * (time.perf_counter() - t0),
                   status=[STATUS_NAMES[int(v)]
                           for v in _on_all(comm, st, dev)])
        xg = arrays[f"x_march{s}"] = _gather(comm, dg, x_slab)
        if lead:
            _sync(dev)
            t0 = time.perf_counter()
            ref_s = coeff_solve(E_s, nu_s, prob.b, x_ref)
            _sync(dev)
            row.update(iters_single=ref_s.iters,
                       rel_single=_rel(xg, ref_s.x),
                       single_ms=1e3 * (time.perf_counter() - t0))
            x_next = ref_s.x
        else:
            x_next = torch.zeros_like(prob.b)
        x_ref = comm.all_gather(x_next)[0]
        steps.append(row)
        if any(v != STATUS_NAMES[HEALTHY] for v in row["status"]) \
                or not bool(ok) or (lead and (
                    it != row["iters_single"]
                    or row["rel_single"] > SOLUTION_TOL)):
            raise AssertionError(f"march step {s}: {row}")
    out = dict(steps=steps, iters=[r["iters"] for r in steps],
               h2d_bytes=[r["h2d_bytes"] for r in steps],
               epad=da.epad,
               staged=[int(v) for v in _on_all(comm, da.n_staged, dev)],
               launches=_summed(comm, own, dev))
    if lead:
        cold = coeff_solve(E_s, nu_s, prob.b, torch.zeros_like(prob.b))
        out.update(iters_single=[r["iters_single"] for r in steps],
                   iters_cold_last=cold.iters)
        if steps[-1]["iters"] > cold.iters:
            raise AssertionError(f"warm march: the last warm step took "
                                 f"more iterations than a cold one: {out}")
    if out["staged"] != [1] * comm.world:
        raise AssertionError(f"the march restaged its rank operands: {out}")
    return out, arrays


def _overlap_on() -> bool:
    from repro_torch.kernels import backend
    return backend.resolve_overlap() == "on"


def _rank(rank: int, opts, init: str) -> None:
    import torch.distributed as tdist

    from repro_torch.dist.comm import RankComm
    if opts.device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        opts.backend, init_method=init, world_size=opts.world, rank=rank,
        timeout=datetime.timedelta(seconds=opts.timeout))
    try:
        res, arrays = _sections(RankComm(), opts, dev)
        if rank == 0:
            print("dist result " + json.dumps(res), flush=True)
            if opts.out:
                np.savez(opts.out, result=json.dumps(res),
                         **{k: v.detach().cpu().numpy()
                            for k, v in arrays.items()})
            print("OK", flush=True)
    finally:
        tdist.destroy_process_group()


def parse_args(argv=None):
    from repro_torch.configs.elasticity import CONFIG
    p = argparse.ArgumentParser(prog="python -m repro_torch.dist.selftest",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("m", type=int, nargs="?", default=CONFIG.m)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--coarse-size", type=int, default=CONFIG.coarse_size)
    p.add_argument("--coarsener", choices=("greedy", "mis"),
                   default=CONFIG.coarsener)
    p.add_argument("--coarse-eq-limit", type=int, default=None)
    p.add_argument("--k", type=int, default=3, help="panel columns")
    p.add_argument("--mrhs", action="store_true")
    p.add_argument("--agg", action="store_true")
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--fault", action="store_true")
    p.add_argument("--coeff", action="store_true",
                   help="the coefficient program on inclusion_fields")
    p.add_argument("--march", action="store_true",
                   help="the warm coefficient march over the wire")
    p.add_argument("--out", default=None, help="save results (.npz)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a collective may wait")
    opts = p.parse_args(argv)
    if opts.world < 1:
        p.error("--world must be >= 1")
    if opts.fault and opts.world < 2:
        p.error("--fault needs --world >= 2 (a single rank has no halo)")
    if opts.k < 2:
        p.error("--k must be >= 2")
    return opts


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    from repro_torch.dist import selftest as this
    from repro_torch.kernels import backend
    opts = parse_args(argv)
    dev = backend.resolve_device(opts.device)
    if opts.backend == "nccl" and dev.type == "cpu":
        raise ValueError("the nccl backend runs on CUDA tensors: pass "
                         "--backend gloo with --device cpu")
    if dev.type == "cuda":
        backend.build_library()      # before any rank can race to build it
    os.environ["REPRO_TORCH_TUNE"] = "off"
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        mp.spawn(this._rank, args=(opts, f"file://{tmp}/rendezvous"),
                 nprocs=opts.world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
