"""Distributed == single-device selftest (torch twin of
``repro.dist.selftest``, without its COEFF and MARCH sections).

    python -m repro_torch.dist.selftest <m> --world N --backend gloo|nccl \\
        --device cpu|cuda [--mrhs] [--agg] [--overlap] [--fault] [--out F]

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
  * on the card, rank 0 also holds the slab applies (level 0's window
    SpMV and a panel, both Galerkin stages) on the kernels against their
    plain versions at this run's shapes (``kernel cases``).

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
        rng = np.random.default_rng(0)
        b_np = prob.b.cpu().numpy()
        cols = [b_np, 0.5 * b_np + rng.standard_normal(prob.n)]
        cols += [rng.standard_normal(prob.n) for _ in range(opts.k - 2)]
        B = torch.as_tensor(np.stack(cols[:opts.k], axis=1)).to(dev)
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
        # the NaN lands on the first entry of level 0's slab ``width`` in
        # its window: the rank's own row 0 under a ppermute halo, which
        # every rank with a left neighbour reads on its boundary rows (an
        # index is taken modulo each window's size; 0 would be a
        # neighbour's far row, which no rank reads)
        halo0 = dg.levels[0].a_op.halo
        spec = (f"halo:nan:index="
                f"{halo0.width * halo0.cpad * int(np.prod(b.shape[1:]))}")
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

    if dev.type == "cuda" and lead:
        res["kernel_cases"] = _kernel_cases(dg, args, opts.k, dev)
        for row in res["kernel_cases"]:
            say("dist kernel case " + json.dumps(row))
    res["staged_bytes"] = comm.staged_bytes
    totals = torch.tensor([counted.total[f] for f in FAMILIES],
                          dtype=torch.float64, device=dev)
    summed = comm.all_gather(totals).sum(dim=0)
    res["launches"] = {f: int(v) for f, v in zip(FAMILIES, summed.tolist())}
    return res, arrays


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
