#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the seven hand-written CUDA kernels from ``src/repro_torch/
kernels/csrc`` and drives four paths of the port on the paper's
configuration ``ElasticityConfig(m=32)``, each with the launch counts set
to 0 just before it and read just after.  The autotuner's cache is a fresh
temporary file (``REPRO_TORCH_TUNE_CACHE``), and the first three paths run
with ``REPRO_TORCH_TUNE=off`` (the static 256-thread launch):

1. the main path — blocked-COO assembly, cold GAMG setup, then 3 hot steps
   of reassembly, ``update_operator`` (the PtAP chain) and the AMG-PCG
   solve (13 iterations each), plus one profiled hot step;
2. the serve path — ``AMGSolveServer`` on the main path's setup, bursts of
   1, 3, 8, 5, 16 and 21 requests in panels of k in {1, 2, 4, 8, 16},
   ``update_operator`` and a burst of 4 copies of ``b`` (13 iterations on
   every column); per-column iterations equal dedicated vector solves;
3. the pairs path — one ``update_operator`` on the unfused "pairs" SpGEMM
   path (``REPRO_TORCH_SPGEMM_PATH=pairs``), held against the fused
   hierarchy (1e-12) and solved (13 iterations), with its peak memory
   beside the fused recompute's;
4. the tune path — the kernel autotuner (``repro_torch.kernels.autotune``)
   sweeps the ``threads`` knob of every (family, signature) the main and
   serve paths launched, plus ``pbjacobi`` at every level's ``dinv``
   shape, records the winners, and runs the CLI's ``smoke`` round trip
   on the card.

After the main path it prints a ``coarse operators`` line: SHA-256 of the
setup's coarse operators and prolongators (all products of
``fused_pair_gemm``) and of the last hot-step solution, required equal to
``EXPECT_COARSE_SHA``.  It checks that each kernel ran on its path, then
holds every kernel
against its plain PyTorch version at the paths' shapes (max relative error
1e-12 at f64; kernels reorder sums), checks that ``block_spmm`` and the
panel ``fused_smoother`` are bitwise per column against ``block_spmv`` and
the vector step and that with ``dinv = I`` and ``coef = [0, 1]`` the
smoother's ``d'`` is bitwise ``b - block_spmv(x)`` on every level, times
kernel, plain version and a one-call PyTorch yardstick beside the kernel's
bound (device time per call: a batch of calls queued behind a sleep kernel
between CUDA events; the single-launch time, host enqueue included, beside
it), and compares the port on the CPU with the port on the card at m=7
(bitwise levels and aggregates, equal CG iterations, solutions within
1e-9, vector and k=4 panel solves). For the tuned kernels it then launches
every ``threads`` candidate at the m=32 shapes and requires the output
bitwise equal to the 256-thread launch, times winner against default with
CUDA events, and runs a hot step and a k=16 panel solve static, tuned,
tuned, static (equal iterations, bitwise solutions), and profiles one
tuned hot step. Last, it sets the port up on the CPU at m=32 and compares
the card's aggregates with it: levels, nnzb and ``n_agg`` equal, and every
node in another aggregate traced back to greedy pass-2 ties within
``TIE_ULPS`` of the CPU's weights (the two operators differ by rounding;
m=7 stays bitwise). ``block_spmv``, ``block_spmm`` and ``fused_smoother``
give each block row a sub-warp of ``ell_rows.lanes(br, bc, kmax)`` lanes,
printed with each of their ``kernel case`` lines; a ``lanes sweep`` line
per case times every lanes value the C entries take beside the map's
choice.  Each ``fused_pair_gemm`` case line carries ``gather_bytes`` (valid
slots x lhs and rhs block bytes) and ``before_ms``, its static time before
the staged redesign.
The second-to-last line is the per-kernel JSON record and the last line
``{"ok": true, "device": ...}``.  Any failure raises (exit code not 0).
Without a CUDA device, or outside a checkout, it exits with code 2 before
printing a result.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

REL_TOL = 1e-12          # kernel vs plain version, f64, scaled by max |plain|
SOLUTION_TOL = 1e-9      # port on CPU vs port on the card
MAIN_M = 32              # ElasticityConfig(m=32): the paper's one-device rung
EXPECT_LEVEL_ROWS = [95232, 7986, 5016, 114]
EXPECT_ITERS = 13        # the JAX reference's count on this configuration
CHECK_M, CHECK_COARSE = 7, 12
TIE_ULPS = 8             # m=32 aggregates: pass-2 ties that may flip
LANES = (1, 2, 4, 8, 16, 32)    # what the ELL kernels' C entries take
BUCKETS = (1, 2, 4, 8, 16)
BURSTS = (1, 3, 8, 5, 16, 21)   # 21 = a full 16 panel + 5 in an 8 panel
CHECKED_BURSTS = (3, 5)         # per column against dedicated solves
PANEL_KS = (16, 4)              # block_spmm cases
TUNE_K = 16                     # the tuned-vs-static panel solve
OMEGA = 0.6                     # pbjacobi cases (the autotuner's omega)
# SHA-256 (first 16 hex digits) of the card's m=32 setup operators and
# prolongators and of the last main-path hot-step solution, as the
# thread-per-element fused_pair_gemm produced them; any later kernel must
# reproduce them bit for bit (None: printed, not checked)
EXPECT_COARSE_SHA = {"A1": "1d2d80d209e5f844", "A2": "4564b2e3d97d46ba",
                     "A3": "ae5480626751045d", "P0": "242d9e8d4d6f8dbe",
                     "P1": "76983f98ab971769", "P2": "efe15001676b62a3",
                     "x": "6cfa8419b2e88538"}
# fused_pair_gemm static device ms per case before the staged redesign
# (NVIDIA H100 80GB HBM3, 700.00 W), shown beside each case's time
BEFORE_PAIR_GEMM_MS = {"level0 AP 813662x6": 0.3015,
                       "level0 R(AP) 143555x15": 0.2423,
                       "level1 AP 372548x4": 0.2888,
                       "level1 R(AP) 791472x6": 0.9601,
                       "level2 AP 136093x21": 0.4769,
                       "level2 R(AP) 536x409": 0.4204}

# Datasheet peaks of the card the port runs on, the H100 SXM ("NVIDIA H100
# 80GB HBM3"): HBM bytes/s and fp64 FLOP/s outside the tensor cores.
CARD = "H100 80GB HBM3"
PEAKS = (3.35e12, 34.0e12)

KERNELS = {
    "block_seg_sum": dict(
        source="src/repro_torch/kernels/csrc/block_seg_sum.cu",
        replaces="src/repro/kernels/block_seg_sum/block_seg_sum.py:49"),
    "block_spmv": dict(
        source="src/repro_torch/kernels/csrc/block_spmv.cu",
        replaces="src/repro/kernels/block_spmv/block_spmv.py:63"),
    "fused_smoother": dict(
        source="src/repro_torch/kernels/csrc/fused_smoother.cu",
        replaces="src/repro/kernels/fused_smoother/fused_smoother.py:74"),
    "fused_pair_gemm": dict(
        source="src/repro_torch/kernels/csrc/fused_pair_gemm.cu",
        replaces="src/repro/kernels/fused_pair_gemm/fused_pair_gemm.py:70"),
    "block_spmm": dict(
        source="src/repro_torch/kernels/csrc/block_spmm.cu",
        replaces="src/repro/kernels/block_spmm/block_spmm.py:49"),
    "block_pair_gemm": dict(
        source="src/repro_torch/kernels/csrc/block_pair_gemm.cu",
        replaces="src/repro/kernels/block_pair_gemm/block_pair_gemm.py:44"),
    "pbjacobi": dict(
        source="src/repro_torch/kernels/csrc/pbjacobi.cu",
        replaces="src/repro/kernels/pbjacobi/pbjacobi.py:35"),
}
#: the kernels with a ``threads`` knob (the autotuner's families)
TUNED = ("block_spmv", "block_spmm", "pbjacobi", "fused_smoother",
         "fused_pair_gemm")


def _ops():
    from repro_torch.kernels.block_pair_gemm import ops as pair
    from repro_torch.kernels.block_seg_sum import ops as seg
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.fused_pair_gemm import ops as gemm
    from repro_torch.kernels.fused_smoother import ops as smooth
    from repro_torch.kernels.pbjacobi import ops as pbj
    return {"block_seg_sum": seg, "block_spmv": spmv,
            "fused_smoother": smooth, "fused_pair_gemm": gemm,
            "block_spmm": spmm, "block_pair_gemm": pair, "pbjacobi": pbj}


def reset_counts():
    for mod in _ops().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _ops().items()}


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median milliseconds of one ``fn()`` between two CUDA events.  The
    card is idle when the first event is recorded, so a short kernel's
    number includes the host's time to enqueue it (kept beside the
    autotuner's ``device_ms`` as ``ms_single``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def main_path(m: int, device, coarse_size: int | None = None,
              steps: int = 3, verbose: bool = True) -> dict:
    """Assemble, set up and run ``steps`` hot steps of the paper's loop
    through the port's entry points; returns the objects and records."""
    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.robust.health import HEALTHY, STATUS_NAMES

    cfg = ElasticityConfig(m=m)
    if coarse_size is not None:
        cfg = ElasticityConfig(m=m, coarse_size=coarse_size)
    t0 = time.perf_counter()
    prob = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               device=device)
    sync(device)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = GAMGSolver(prob.A, prob.B, theta=cfg.theta,
                        smoother=cfg.smoother, degree=cfg.degree,
                        coarse_size=cfg.coarse_size,
                        coarsener=cfg.coarsener, rtol=cfg.rtol,
                        maxiter=cfg.maxiter)
    sync(device)
    t_setup = time.perf_counter() - t0
    stats = solver.setup_data.stats
    if verbose:
        print(f"main path m={m}: n={prob.n} nnzb={prob.A.nnzb} "
              f"coo_inputs={prob.coo_plan.n_input} "
              f"assemble_s={t_asm:.3f} setup_s={t_setup:.3f} "
              f"level_rows={stats['level_rows']} "
              f"level_bs={stats['level_bs']}")
    records = []
    for step in range(steps):
        rec = {"step": step}
        c0 = read_counts()
        t0 = time.perf_counter()
        a_new = prob.reassemble(1.0 + 0.1 * step)
        sync(device)
        rec["reassemble_ms"] = 1e3 * (time.perf_counter() - t0)
        c1 = read_counts()
        t0 = time.perf_counter()
        solver.update_operator(a_new.data)
        sync(device)
        rec["update_operator_ms"] = 1e3 * (time.perf_counter() - t0)
        c2 = read_counts()
        t0 = time.perf_counter()
        res = solver.solve(prob.b)
        sync(device)
        rec["solve_ms"] = 1e3 * (time.perf_counter() - t0)
        c3 = read_counts()
        rec.update(iters=res.iters, relres=float(res.relres),
                   status=STATUS_NAMES[int(res.health.status)],
                   healthy=int(res.health.status) == HEALTHY,
                   launches={
                       "reassemble": _diff(c1, c0),
                       "update_operator": _diff(c2, c1),
                       "solve": _diff(c3, c2)})
        rec["x"] = res.x
        records.append(rec)
        a_data = a_new.data
        if verbose:
            shown = {k: (round(v, 3) if isinstance(v, float) and k != "relres"
                         else v) for k, v in rec.items() if k != "x"}
            print("hot step " + json.dumps(shown))
    return dict(prob=prob, solver=solver, records=records, setup_s=t_setup,
                assemble_s=t_asm, a_data=a_data)


def profile_hot_step(run: dict, top: int = 12, label: str = "") -> None:
    """One more hot step under ``torch.profiler``: device time by kernel
    and the card's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prob, solver = run["prob"], run["solver"]
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for phase in ("reassemble", "update_operator", "solve"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if phase == "reassemble":
                a_new = prob.reassemble(1.3)
            elif phase == "update_operator":
                solver.update_operator(a_new.data)
                run["a_data"] = a_new.data
            else:
                solver.solve(prob.b)
            torch.cuda.synchronize()
            walls[phase] = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    wall_ms = sum(walls.values())
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"profiled {label}hot step " + json.dumps(dict(
        wall_ms=walls, device_busy_ms=busy_ms, device_events=len(kernels),
        idle_share=1.0 - busy_ms / wall_ms)))
    for name, (n, t) in rows:
        print(f"profile {label}kernel " + json.dumps(dict(
            name=name[:90], launches=n, device_ms=t,
            share=t / busy_ms if busy_ms else 0.0)))


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def check_main_path(run: dict) -> None:
    stats = run["solver"].setup_data.stats
    if stats["level_rows"] != EXPECT_LEVEL_ROWS:
        raise AssertionError(f"level_rows {stats['level_rows']} != "
                             f"{EXPECT_LEVEL_ROWS}")
    for rec in run["records"]:
        if not rec["healthy"]:
            raise AssertionError(f"step {rec['step']}: status "
                                 f"{rec['status']}")
        if rec["iters"] != EXPECT_ITERS:
            raise AssertionError(f"step {rec['step']}: {rec['iters']} CG "
                                 f"iterations, expected {EXPECT_ITERS}")
        want = {"reassemble": ["block_seg_sum"],
                "update_operator": ["fused_pair_gemm", "block_seg_sum"],
                "solve": ["block_spmv", "fused_smoother"]}
        for phase, names in want.items():
            for name in names:
                if rec["launches"][phase][name] <= 0:
                    raise AssertionError(
                        f"step {rec['step']}: {name} did not launch during "
                        f"{phase}")


def _sha(t) -> str:
    arr = t.detach().contiguous().cpu().numpy()
    h = hashlib.sha256(f"{arr.dtype} {arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


def coarse_fingerprint(run: dict) -> dict:
    """SHA-256 of the setup's coarse operators (A1.., the coarsest one
    last), its prolongators (P0..) and the last hot-step solution: every
    one of them runs through ``fused_pair_gemm``, so a kernel that moves a
    single rounding changes a hash."""
    setupd = run["solver"].setup_data
    out = {f"A{li}": _sha(ls.A0.data)
           for li, ls in enumerate(setupd.levels) if li}
    out[f"A{len(setupd.levels)}"] = _sha(setupd.coarse_struct.data)
    out.update({f"P{li}": _sha(ls.P.data)
                for li, ls in enumerate(setupd.levels)})
    out["x"] = _sha(run["records"][-1]["x"])
    return out


def check_fingerprint(run: dict) -> dict:
    got = coarse_fingerprint(run)
    if EXPECT_COARSE_SHA is not None and got != EXPECT_COARSE_SHA:
        differ = sorted(k for k in got if got[k] != EXPECT_COARSE_SHA.get(k))
        raise AssertionError(f"coarse operators not bitwise the expected "
                             f"ones: {differ} differ ({got})")
    return dict(sha256_16=got, checked=EXPECT_COARSE_SHA is not None)


class PathCounts:
    """Kernel launches of one path: the sum of the count deltas around the
    path's own calls (checks made in between do not count)."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}

    def run(self, fn):
        c0 = read_counts()
        out = fn()
        delta = _diff(read_counts(), c0)
        for k, v in delta.items():
            self.total[k] += v
        return out, delta


def _rel(got, want) -> float:
    """max |got - want| / max |want| of two tensors, or of two tuples of
    tensors taken together, on any devices."""
    import torch
    if isinstance(got, tuple):
        got, want = (torch.cat([t.reshape(-1) for t in v]) for v in (got,
                                                                     want))
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale else err


def serve_path(run: dict, device, expect_iters: int,
               verbose: bool = True) -> dict:
    """The solve server on the main path's setup: bursts of requests in
    bucketed panels, an operator update and a burst of ``b``.  Returns
    the path's kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core.gamg import hier_solve
    from repro_torch.multirhs import AMGSolveServer

    prob, setupd = run["prob"], run["solver"].setup_data
    counts = PathCounts()
    reset_counts()
    server, _ = counts.run(lambda: AMGSolveServer(
        setupd, run["a_data"], buckets=BUCKETS, rtol=1e-8, maxiter=200))
    rng = np.random.default_rng(0)
    n_reports, vector_ms = 0, []
    plan = [(burst, [rng.standard_normal(prob.n) for _ in range(burst)])
            for burst in BURSTS]
    b_host = prob.b.cpu().numpy()
    plan.append(("update", [b_host] * 4))
    for burst, rhs in plan:
        if burst == "update":
            a_new = prob.reassemble(1.2).data
            counts.run(lambda: server.update_operator(a_new))
        sync(device)
        t0 = time.perf_counter()
        reports, delta = counts.run(lambda: server.serve(rhs))
        wall_ms = 1e3 * (time.perf_counter() - t0)
        n_reports += len(reports)
        its = [r.iters for r in reports]
        # flush solves chunks of up to BUCKETS[-1] requests, one panel each
        panels = [r.k_bucket for r in reports[::BUCKETS[-1]]]
        line = dict(burst=burst, requests=len(rhs), buckets=panels,
                    iters=[min(its), max(its)], wall_ms=wall_ms,
                    ms_per_request=wall_ms / len(rhs),
                    launches={k: delta[k] for k in ("block_spmm",
                                                    "fused_smoother",
                                                    "block_spmv")})
        bad = [r for r in reports if r.status != "ok" or not r.converged]
        if bad:
            raise AssertionError(f"burst {burst}: {len(bad)} reports not ok:"
                                 f" {[(r.request_id, r.status) for r in bad]}")
        if burst == "update" and its != [expect_iters] * len(rhs):
            raise AssertionError(f"post-update burst: iterations {its}, "
                                 f"expected {expect_iters} on every column")
        if burst in CHECKED_BURSTS:
            for r, b in zip(reports, rhs):
                bt = torch.as_tensor(b, device=device)
                sync(device)
                t0 = time.perf_counter()
                v = hier_solve(setupd, server.hierarchy, bt, rtol=1e-8,
                               maxiter=200)
                sync(device)
                vector_ms.append(1e3 * (time.perf_counter() - t0))
                rel = _rel(torch.as_tensor(r.x), v.x)
                if v.iters != r.iters or not rel <= SOLUTION_TOL:
                    raise AssertionError(
                        f"burst {burst} request {r.request_id}: panel "
                        f"{r.iters} iterations, vector {v.iters}; solutions "
                        f"differ by {rel:.3e}")
            line["vector_check"] = "iterations equal, solutions within 1e-9"
        if verbose:
            print("serve burst " + json.dumps(line))
    want = sum(BURSTS) + 4
    if n_reports != want:
        raise AssertionError(f"serve: {n_reports} reports, expected {want}")
    if verbose:
        print("serve path " + json.dumps(dict(
            reports=n_reports, stats=server.stats,
            vector_solve_ms_median=statistics.median(vector_ms),
            launches=counts.total)))
    return counts.total


def pairs_path(run: dict, device, expect_iters: int,
               verbose: bool = True) -> dict:
    """One ``update_operator`` on the "pairs" SpGEMM path at the values of
    the current fused hierarchy, held against it and solved; then the
    fused recompute again, for its peak memory.  Returns the path's
    kernel launches."""
    import torch
    prob, solver = run["prob"], run["solver"]
    a = run["a_data"]
    fused = solver.hierarchy
    cuda = torch.device(device).type == "cuda"
    counts = PathCounts()
    reset_counts()

    def recompute(path):
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        os.environ["REPRO_TORCH_SPGEMM_PATH"] = path
        t0 = time.perf_counter()
        try:
            _, delta = counts.run(lambda: solver.update_operator(a))
        finally:
            del os.environ["REPRO_TORCH_SPGEMM_PATH"]
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        return dict(ms=ms, peak_bytes_above_live=peak, launches=delta)

    pairs = recompute("pairs")
    hier = solver.hierarchy
    errs = {"coarse_chol": _rel(hier.coarse_chol, fused.coarse_chol)}
    for li, (p, f) in enumerate(zip(hier.levels, fused.levels)):
        errs[f"level{li} a_ell.data"] = _rel(p.a_ell.data, f.a_ell.data)
        errs[f"level{li} dinv"] = _rel(p.dinv, f.dinv)
        errs[f"level{li} lam_max"] = _rel(p.lam_max, f.lam_max)
    worst = max(errs.values())
    if not worst <= REL_TOL:
        raise AssertionError(f"pairs vs fused hierarchy: {errs}")
    res, _ = counts.run(lambda: solver.solve(prob.b))
    if res.iters != expect_iters or int(res.health.status) != 0:
        raise AssertionError(f"pairs hierarchy: {res.iters} iterations, "
                             f"status {int(res.health.status)}")
    del hier
    fused_rec = recompute("fused")
    if verbose:
        print("pairs path " + json.dumps(dict(
            pairs=pairs, fused=fused_rec, max_rel_err=worst, iters=res.iters,
            launches=counts.total)))
    return counts.total


def check_path_launches(name: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{k} did not launch on the {name} path")


# ---------------------------------------------------------------------------
# Kernel vs plain version at the main path's shapes
# ---------------------------------------------------------------------------

class Case:
    """One kernel call at a main-path shape: the wrapper, the plain version
    and an optional one-call PyTorch yardstick on the same inputs.  A
    tuned kernel's ``run`` takes ``threads=`` (None resolves it)."""

    def __init__(self, kernel, label, run, plain, nbytes, flops,
                 library=None, lanes=None, at_lanes=None, extra=None):
        self.kernel, self.label = kernel, label
        self.run, self.plain, self.library = run, plain, library
        self.nbytes, self.flops = nbytes, flops
        # printed with the case (fused_pair_gemm: gather bytes, the time
        # before the redesign)
        self.extra = extra or {}
        # the ELL kernels (block_spmv, block_spmm, fused_smoother): the
        # map's lanes, and the kernel at any lanes (256 threads) for the
        # sweep of the map's choice
        self.lanes, self.at_lanes = lanes, at_lanes


def _unique_count(idx, mask=None) -> int:
    import torch
    sel = idx if mask is None else idx[mask]
    return int(torch.unique(sel).numel())


def build_cases(run: dict, device) -> list:
    import torch

    from repro_torch.core.block_csr import device_array
    from repro_torch.core.ptap import ptap_numeric_data
    from repro_torch.core.spgemm import spgemm_numeric_data
    from repro_torch.kernels.block_pair_gemm import ops as pair
    from repro_torch.kernels.block_pair_gemm.ref import block_pair_gemm_ref
    from repro_torch.kernels.block_seg_sum import ops as seg
    from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.autotune import DEFAULT_THREADS
    from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref
    from repro_torch.kernels.ell_rows import lanes
    from repro_torch.kernels.fused_pair_gemm import ops as gemm
    from repro_torch.kernels.fused_pair_gemm.ref import fused_pair_gemm_ref
    from repro_torch.kernels.fused_smoother import ops as smooth
    from repro_torch.kernels.fused_smoother.ref import smoother_step_ref
    from repro_torch.kernels.pbjacobi import ops as pbj
    from repro_torch.kernels.pbjacobi.ref import pbjacobi_update_ref

    prob, solver = run["prob"], run["solver"]
    setupd, hier = solver.setup_data, solver.hierarchy
    gen = torch.Generator(device=device).manual_seed(0)
    f64 = dict(dtype=torch.float64, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, **f64)

    cases = []
    # --- block_seg_sum: the COO reassembly stream ------------------------
    plan = prob.coo_plan
    vals = (prob.values * 1.2).contiguous()
    offs = device_array(plan, "offsets", device, torch.int32)
    perm = device_array(plan, "perm", device, torch.int32)
    kept = vals[device_array(plan, "keep", device)]
    slot_of_kept = torch.empty_like(device_array(plan, "keep", device))
    slot_of_kept[device_array(plan, "order", device)] = device_array(
        plan, "out_idx_sorted", device)
    n_kept = int(perm.numel())
    cases.append(Case(
        "block_seg_sum", f"coo stream {n_kept}x3x3 -> {plan.nnzb}",
        lambda: seg.block_seg_sum(vals, offs, perm),
        lambda: block_seg_sum_ref(vals, offs, perm),
        nbytes=n_kept * (72 + 4) + offs.numel() * 4 + plan.nnzb * 72,
        flops=n_kept * 9,
        library=lambda: torch.zeros((plan.nnzb, 3, 3), **f64).index_add_(
            0, slot_of_kept, kept)))

    # --- block_spmv and fused_smoother on every level operator, block_spmv
    # on every prolongator --------------------------------------------------
    for li, lv in enumerate(hier.levels):
        for tag, ell in (("A", lv.a_ell), ("P", lv.p_ell)):
            nnz = int(ell.mask.sum())
            x = randn(ell.nbc, ell.bc)
            csr = _scalar_csr(ell)
            xf = x.reshape(-1)
            nl = lanes(ell.br, ell.bc, ell.kmax)
            cases.append(Case(
                "block_spmv",
                f"{tag}{li} ({ell.nbr},{ell.kmax},{ell.br},{ell.bc})",
                lambda threads=None, ell=ell, x=x: spmv.block_spmv_ell(
                    ell.indices, ell.data, x, threads=threads),
                lambda ell=ell, x=x: block_spmv_ell_ref(ell.indices,
                                                        ell.data, x),
                nbytes=nnz * (ell.br * ell.bc * 8 + 4) + x.numel() * 8
                + ell.nbr * ell.br * 8,
                flops=2 * nnz * ell.br * ell.bc,
                library=lambda csr=csr, xf=xf: torch.mv(csr, xf), lanes=nl,
                at_lanes=lambda n, ell=ell, x=x: spmv.launch_lanes(
                    ell.indices, ell.data, x, n, DEFAULT_THREADS)))
            for k in PANEL_KS:
                X = randn(ell.nbc, ell.bc, k)
                Xf = X.reshape(ell.nbc * ell.bc, k)
                cases.append(Case(
                    "block_spmm",
                    f"{tag}{li} ({ell.nbr},{ell.kmax},{ell.br},{ell.bc}) "
                    f"k={k}",
                    lambda threads=None, ell=ell, X=X: spmm.block_spmm_ell(
                        ell.indices, ell.data, X, threads=threads),
                    lambda ell=ell, X=X: block_spmm_ell_ref(
                        ell.indices, ell.data, X),
                    nbytes=nnz * (ell.br * ell.bc * 8 + 4) + X.numel() * 8
                    + ell.nbr * ell.br * k * 8,
                    flops=2 * nnz * ell.br * ell.bc * k,
                    library=lambda csr=csr, Xf=Xf: torch.sparse.mm(csr, Xf),
                    lanes=nl, at_lanes=lambda n, ell=ell, X=X:
                    spmm.launch_lanes(ell.indices, ell.data, X, n,
                                      DEFAULT_THREADS)))
        a = lv.a_ell
        bs = a.br
        nnz = int(a.mask.sum())
        nl = lanes(bs, bs, a.kmax)
        coef = torch.tensor([0.3, 0.7], **f64)
        for k in (None, PANEL_KS[0]):
            cols = () if k is None else (k,)
            b, x, d = (randn(a.nbr, bs, *cols) for _ in range(3))
            args = (a.indices, a.data, lv.dinv, b, x, d, coef)
            cases.append(Case(
                "fused_smoother", f"A{li} ({a.nbr},{a.kmax},{bs},{bs})"
                + ("" if k is None else f" k={k}"),
                lambda threads=None, args=args: smooth.smoother_step_ell(
                    *args, threads=threads),
                lambda args=args: smoother_step_ref(*args),
                nbytes=nnz * (bs * bs * 8 + 4) + a.nbr * bs * bs * 8
                + 5 * a.nbr * bs * (k or 1) * 8,
                flops=(k or 1) * (2 * nnz * bs * bs + 2 * a.nbr * bs * bs
                                  + 4 * a.nbr * bs),
                lanes=nl, at_lanes=lambda n, args=args:
                smooth.launch_lanes(*args, n, DEFAULT_THREADS)))
        # pbjacobi at the level's dinv shape; torch.baddbmm computes the
        # same x + omega * dinv @ r in one call
        r, x = randn(a.nbr, bs), randn(a.nbr, bs)
        cases.append(Case(
            "pbjacobi", f"L{li} dinv ({a.nbr},{bs},{bs})",
            lambda threads=None, lv=lv, r=r, x=x: pbj.pbjacobi_update(
                lv.dinv, r, x, OMEGA, threads=threads),
            lambda lv=lv, r=r, x=x: pbjacobi_update_ref(lv.dinv, r, x,
                                                        OMEGA),
            nbytes=a.nbr * bs * bs * 8 + 3 * a.nbr * bs * 8,
            flops=a.nbr * bs * (2 * bs + 2),
            library=lambda lv=lv, r=r, x=x: torch.baddbmm(
                x[..., None], lv.dinv, r[..., None], alpha=OMEGA)[..., 0]))

    # --- fused_pair_gemm on both Galerkin products of every level, and the
    # block_seg_sum row-split combine where rows split -----------------------
    a_data = prob.A.data
    for li, ls in enumerate(setupd.levels):
        cache = ls.ptap_cache
        p_data = ls.P.data
        r_data = p_data[device_array(cache, "r_perm", device)].transpose(
            1, 2).contiguous()
        ap = spgemm_numeric_data(cache.ap_plan, a_data, p_data)
        for tag, sp, lhs_data, rhs_data in (("AP", cache.ap_plan, a_data,
                                             p_data),
                                            ("R(AP)", cache.ac_plan, r_data,
                                             ap)):
            ta = device_array(sp, "tile_pair_a", device, torch.int32)
            tb = device_array(sp, "tile_pair_b", device, torch.int32)
            tm = device_array(sp, "tile_mask", device, torch.bool)
            gargs = (lhs_data, rhs_data, ta, tb, tm)
            lhs = torch.where(tm[..., None, None], lhs_data[ta.long()],
                              torch.zeros((), **f64))
            rhs = rhs_data[tb.long()]
            br, bk, bc = sp.br, sp.bk, sp.bc
            # the "pairs" path's operands: one gathered block per pair
            plhs = lhs_data[device_array(sp, "pair_a", device)]
            prhs = rhs_data[device_array(sp, "pair_b", device)]
            cases.append(Case(
                "block_pair_gemm",
                f"level{li} {tag} {sp.npairs} pairs ({br},{bk},{bc})",
                lambda plhs=plhs, prhs=prhs: pair.block_pair_gemm(plhs, prhs),
                lambda plhs=plhs, prhs=prhs: block_pair_gemm_ref(plhs, prhs),
                nbytes=sp.npairs * (br * bk + bk * bc + br * bc) * 8,
                flops=2 * sp.npairs * br * bk * bc,
                library=lambda plhs=plhs, prhs=prhs: torch.bmm(plhs, prhs)))
            nbytes = (_unique_count(ta, tm) * br * bk * 8
                      + _unique_count(tb, tm) * bk * bc * 8
                      + ta.numel() * 9 + sp.tile_rows * br * bc * 8)
            # what the tile plan gathers when every pair reads its own
            # blocks: valid slots x (lhs + rhs block bytes)
            gather = int(tm.sum()) * (br * bk + bk * bc) * 8
            cases.append(Case(
                "fused_pair_gemm",
                f"level{li} {tag} {sp.tile_rows}x{sp.pair_kmax} "
                f"({br},{bk},{bc})",
                lambda threads=None, gargs=gargs: gemm.fused_pair_gemm(
                    *gargs, threads=threads),
                lambda gargs=gargs: fused_pair_gemm_ref(*gargs),
                nbytes=nbytes, flops=2 * sp.npairs * br * bk * bc,
                library=lambda lhs=lhs, rhs=rhs: torch.einsum(
                    "skij,skjl->sil", lhs, rhs),
                extra=dict(gather_bytes=gather, before_ms=BEFORE_PAIR_GEMM_MS
                           .get(f"level{li} {tag} {sp.tile_rows}x"
                                f"{sp.pair_kmax}"))))
            if not sp.tile_identity:
                part = gemm.fused_pair_gemm(*gargs)
                toffs = device_array(sp, "tile_offsets", device, torch.int32)
                tseg = device_array(sp, "tile_seg", device)
                cases.append(Case(
                    "block_seg_sum",
                    f"level{li} {tag} combine {sp.tile_rows} -> {sp.nnzb} "
                    f"({br},{bc})",
                    lambda part=part, toffs=toffs: seg.block_seg_sum(
                        part, toffs),
                    lambda part=part, toffs=toffs: block_seg_sum_ref(
                        part, toffs),
                    nbytes=part.numel() * 8 + toffs.numel() * 4
                    + sp.nnzb * br * bc * 8,
                    flops=part.numel(),
                    library=lambda part=part, tseg=tseg, sp=sp, br=br,
                    bc=bc: torch.zeros((sp.nnzb, br, bc), **f64)
                    .index_add_(0, tseg, part)))
        a_data = ptap_numeric_data(cache, a_data, p_data)
    return cases


def _scalar_csr(ell):
    """cuSPARSE's operand for the yardstick: the ELL operator expanded to
    scalar CSR (the paper's scalar AIJ baseline)."""
    import torch
    r, k = torch.nonzero(ell.mask, as_tuple=True)
    br, bc = ell.br, ell.bc
    a = torch.arange(br, device=r.device)
    b = torch.arange(bc, device=r.device)
    rows = (r[:, None, None] * br + a[None, :, None]).expand(-1, br, bc)
    cols = (ell.indices[r, k].long()[:, None, None] * bc
            + b[None, None, :]).expand(-1, br, bc)
    vals = ell.data[r, k]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]), vals.reshape(-1),
        (ell.nbr * br, ell.nbc * bc))
    return coo.coalesce().to_sparse_csr()


def check_bitwise(run: dict, device) -> dict:
    """Each column of ``block_spmm`` is bitwise ``block_spmv`` of that
    column, on every level operator and prolongator at every panel width;
    a width-1 panel is bitwise the vector apply; each column of the panel
    smoother step is bitwise the vector step; and with ``dinv = I`` and
    ``coef = [0, 1]`` the smoother's ``d'`` is bitwise ``b -
    block_spmv(x)``, vector and each panel column, on every level."""
    import torch

    from repro_torch.core.spmv import apply_ell
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.fused_smoother import ops as smooth

    gen = torch.Generator(device=device).manual_seed(1)
    f64 = dict(dtype=torch.float64, device=device)
    checked = dict(spmm_columns=0, apply_width1=0, smoother_columns=0,
                   identity_residuals=0)

    def same(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bitwise equal (max diff "
                                 f"{float((got - want).abs().max()):.3e})")

    for li, lv in enumerate(run["solver"].hierarchy.levels):
        for tag, ell in (("A", lv.a_ell), ("P", lv.p_ell)):
            for k in PANEL_KS + (1,):
                X = torch.randn(ell.nbc, ell.bc, k, generator=gen, **f64)
                Y = spmm.block_spmm_ell(ell.indices, ell.data, X)
                for j in range(k):
                    same(Y[:, :, j], spmv.block_spmv_ell(
                        ell.indices, ell.data, X[:, :, j].contiguous()),
                        f"block_spmm {tag}{li} k={k} column {j}")
                    checked["spmm_columns"] += 1
            x = torch.randn(ell.nbc * ell.bc, generator=gen, **f64)
            same(apply_ell(ell, x[:, None])[:, 0], apply_ell(ell, x),
                 f"width-1 panel apply {tag}{li}")
            checked["apply_width1"] += 1
        a, bs, k = lv.a_ell, lv.a_ell.br, PANEL_KS[0]
        b, x, d = (torch.randn(a.nbr, bs, k, generator=gen, **f64)
                   for _ in range(3))
        coef = torch.tensor([0.3, 0.7], **f64)
        xp, dp = smooth.smoother_step_ell(a.indices, a.data, lv.dinv, b, x,
                                          d, coef)
        for j in range(k):
            xv, dv = smooth.smoother_step_ell(
                a.indices, a.data, lv.dinv,
                *(v[:, :, j].contiguous() for v in (b, x, d)), coef)
            same(xp[:, :, j], xv, f"panel smoother A{li} column {j} x'")
            same(dp[:, :, j], dv, f"panel smoother A{li} column {j} d'")
            checked["smoother_columns"] += 1
        eye = torch.eye(bs, **f64).expand(a.nbr, bs, bs).contiguous()
        step = torch.tensor([0.0, 1.0], **f64)
        _, dp = smooth.smoother_step_ell(a.indices, a.data, eye, b, x, d,
                                         step)
        for j in range(k):
            bj, xj, dj = (v[:, :, j].contiguous() for v in (b, x, d))
            res = bj - spmv.block_spmv_ell(a.indices, a.data, xj)
            same(dp[:, :, j], res, f"identity smoother A{li} column {j} d' "
                 f"against b - A x")
            if j == 0:
                same(smooth.smoother_step_ell(a.indices, a.data, eye, bj, xj,
                                              dj, step)[1], res,
                     f"identity smoother A{li} vector d' against b - A x")
                checked["identity_residuals"] += 1
            checked["identity_residuals"] += 1
    return checked


def check_kernels(cases: list, peaks: tuple, timed: bool = True) -> dict:
    """Hold every case's kernel against its plain version; time it."""
    import torch

    from repro_torch.kernels.autotune import device_ms
    bw, fp = peaks
    per = {name: dict(cases=0, max_abs_err=0.0, max_rel_err=0.0, ms=0.0,
                      ms_single=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=0.0, library_all=True, bytes=0, flops=0)
           for name in KERNELS}
    for c in cases:
        got, want = c.run(), c.plain()
        if isinstance(got, tuple):
            got, want = torch.cat([g.reshape(-1) for g in got]), \
                torch.cat([w.reshape(-1) for w in want])
        sync(got.device)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = err / scale if scale else err
        if not rel <= REL_TOL:
            raise AssertionError(f"{c.kernel} {c.label}: max rel err {rel:.3e}"
                                 f" > {REL_TOL}")
        row = per[c.kernel]
        row["cases"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)
        bound = 1e3 * max(c.nbytes / bw, c.flops / fp)
        row["bound_ms"] += bound
        row["bytes"] += c.nbytes
        row["flops"] += c.flops
        line = dict(kernel=c.kernel, case=c.label, max_abs_err=err,
                    max_rel_err=rel, bound_ms=bound, bytes=c.nbytes)
        if c.lanes is not None:
            line["lanes"] = c.lanes
        line.update(c.extra)
        if timed:
            k_ms, p_ms = device_ms(c.run), device_ms(c.plain)
            l_ms = device_ms(c.library) if c.library is not None else None
            s_ms = time_ms(c.run)
            row["ms"] += k_ms
            row["ms_single"] += s_ms
            row["plain_ms"] += p_ms
            if l_ms is None:
                row["library_all"] = False
            else:
                row["library_ms"] += l_ms
            line.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                        ms_single=s_ms)
        print("kernel case " + json.dumps(line))
    return per


def lanes_sweep(cases: list) -> None:
    """``block_spmv``, ``block_spmm`` and ``fused_smoother`` at every lanes
    value a C entry takes, at the paths' shapes and 256 threads: each held
    against the plain version, timed with CUDA events beside the map's
    choice (the map is no knob; this shows what it leaves on the table)."""
    from repro_torch.kernels.autotune import device_ms
    for c in cases:
        if c.at_lanes is None:
            continue
        want = c.plain()
        ms = {}
        for n in LANES:
            rel = _rel(c.at_lanes(n), want)
            if not rel <= REL_TOL:
                raise AssertionError(f"{c.kernel} {c.label} lanes={n}: max "
                                     f"rel err {rel:.3e} > {REL_TOL}")
            ms[n] = device_ms(lambda n=n: c.at_lanes(n))
        best = min(ms, key=ms.get)
        print("lanes sweep " + json.dumps(dict(
            kernel=c.kernel, case=c.label, map=c.lanes, ms_by_lanes=ms,
            best=best, map_over_best=ms[c.lanes] / ms[best])))


def copy_bandwidth() -> float:
    """Measured bytes/s of a large device-to-device ``copy_``."""
    import torch
    src = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms * 1e-3)


# ---------------------------------------------------------------------------
# The tune path: the autotuner's threads knob
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tune_mode(mode: str):
    """``REPRO_TORCH_TUNE`` set to ``mode`` inside the block."""
    old = os.environ.get("REPRO_TORCH_TUNE")
    os.environ["REPRO_TORCH_TUNE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_TORCH_TUNE"]
        else:
            os.environ["REPRO_TORCH_TUNE"] = old


class SignatureLog:
    """Inside the block, every ``(family, signature)`` the tuned wrappers
    resolve, with the value it resolved to (``autotune.resolve_param`` is
    wrapped and restored on exit)."""

    def __init__(self):
        from repro_torch.kernels import autotune
        self.autotune = autotune
        self.seen = {}

    def __enter__(self):
        at = self.autotune
        self._orig = orig = at.resolve_param

        def logged(family, signature, name, requested, default,
                   device="cuda"):
            value = orig(family, signature, name, requested, default,
                         device=device)
            self.seen[at.entry_key(family, signature)] = (
                family, dict(signature), value)
            return value
        at.resolve_param = logged
        return self

    def __exit__(self, *exc):
        self.autotune.resolve_param = self._orig


def tune_path(run: dict, sigs: dict, device, verbose: bool = True):
    """Sweep every logged ``(family, signature)`` and ``pbjacobi`` at each
    level's ``dinv`` shape on ``device`` into the cache, check that every
    winner reads back, then the CLI's ``smoke`` round trip.  Returns the
    path's kernel launches and the winners by entry key."""
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune.__main__ import main as tune_cli

    todo = {k: (fam, sig) for k, (fam, sig, _) in sigs.items()}
    for lv in run["solver"].hierarchy.levels:
        nbr, bs = lv.dinv.shape[0], lv.dinv.shape[1]
        sig = autotune.signature(lv.dinv.dtype, nbr * bs, bs=bs)
        todo[autotune.entry_key("pbjacobi", sig)] = ("pbjacobi", sig)
    counts = PathCounts()
    reset_counts()
    winners = {}
    for key, (family, sig) in sorted(todo.items()):
        t0 = time.perf_counter()
        won, _ = counts.run(lambda: autotune.sweep(family, sig,
                                                   device=device))
        winners[key] = won["params"]["threads"]
        if verbose:
            print("tune sweep " + json.dumps(dict(
                family=family, signature=sig, table_us=won["table"],
                winner=won["params"], best_us=won["best_us"],
                sweep_s=time.perf_counter() - t0)))
    autotune.clear_memo()
    for key, (family, sig) in todo.items():
        got = autotune.lookup(family, sig, "threads", device)
        if got != winners[key]:
            raise AssertionError(f"cache round trip {key}: recorded "
                                 f"{winners[key]}, read {got}")
    with tune_mode("cache"):
        rc, _ = counts.run(lambda: tune_cli(
            ["smoke", "--device", torch.device(device).type]))
    if rc != 0:
        raise AssertionError(f"autotune CLI smoke exited {rc}")
    if verbose:
        print("tune path " + json.dumps(dict(
            signatures=len(todo), cache=str(autotune.cache_path()),
            launches=counts.total)))
    return counts.total, winners


def check_threads_bitwise(cases: list) -> dict:
    """Every ``threads`` candidate of each tuned kernel, at the paths'
    shapes, bitwise equal to the 256-thread launch: no kernel shares data
    across threads, so the block size changes nothing but speed."""
    import torch
    from repro_torch.kernels import autotune
    checked = {name: 0 for name in TUNED}
    for c in cases:
        if c.kernel not in TUNED:
            continue
        want = c.run(threads=autotune.DEFAULT_THREADS)
        for t in autotune.CANDIDATES[c.kernel]["threads"]:
            got = c.run(threads=t)
            pairs = zip(got, want) if isinstance(got, tuple) else \
                [(got, want)]
            for g, w in pairs:
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{c.kernel} {c.label}: threads={t} differs from "
                        f"the 256-thread launch")
            checked[c.kernel] += 1
    for name, n in checked.items():
        if n == 0:
            raise AssertionError(f"{name}: no threads candidate checked")
    return checked


def tuned_vs_static_kernels(cases: list, verbose: bool = True) -> list:
    """Each tuned case at the cached winner against the static 256-thread
    launch, device times with CUDA events in turns (static, tuned, tuned,
    static; each number the mean of its two medians).  ``beyond_margin``
    marks a winner slower than 256 by more than the sweep's
    ``EVENT_MARGIN`` (the sweep ran on synthetic operands, these on the
    paths' own)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune import device_ms
    rows = []
    for c in cases:
        if c.kernel not in TUNED:
            continue
        with tune_mode("cache"), SignatureLog() as log:
            c.run()
        (_, sig, won), = log.seen.values()
        static = lambda c=c: c.run(threads=autotune.DEFAULT_THREADS)
        tuned = lambda c=c, won=won: c.run(threads=won)
        s1, t1, t2, s2 = (device_ms(static), device_ms(tuned),
                          device_ms(tuned), device_ms(static))
        row = dict(kernel=c.kernel, case=c.label, items=sig["items"],
                   threads=won, static_ms=(s1 + s2) / 2,
                   tuned_ms=(t1 + t2) / 2, static_pair=[s1, s2],
                   tuned_pair=[t1, t2],
                   beyond_margin=t1 + t2 > (s1 + s2) * (
                       1 + autotune.EVENT_MARGIN))
        if c.extra.get("before_ms") is not None:
            row["before_ms"] = c.extra["before_ms"]
        rows.append(row)
        if verbose:
            print("tune kernel " + json.dumps(row))
    return rows


def tuned_vs_static_steps(run: dict, device, expect_iters: int,
                          verbose: bool = True) -> dict:
    """One hot step (reassembly, ``update_operator``, solve) and one
    k=16 panel solve with the static launch and with the cached winners,
    in turns: static, tuned, tuned, static.  Iterations must be equal
    (``expect_iters`` on the hot step) and the solutions bitwise equal."""
    import numpy as np
    import torch
    prob, solver = run["prob"], run["solver"]
    B = torch.as_tensor(np.random.default_rng(TUNE_K).standard_normal(
        (prob.n, TUNE_K)), device=device)
    out = []
    for mode in ("off", "cache", "cache", "off"):
        with tune_mode(mode):
            sync(device)
            t0 = time.perf_counter()
            a_new = prob.reassemble(1.1)
            solver.update_operator(a_new.data)
            res = solver.solve(prob.b)
            sync(device)
            step_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            panel = solver.solve_many(B)
            sync(device)
            panel_ms = 1e3 * (time.perf_counter() - t0)
        out.append(dict(mode=mode, step_ms=step_ms, iters=res.iters,
                        x=res.x, panel_ms=panel_ms,
                        panel_iters=panel.iters.tolist(), X=panel.x))
    run["a_data"] = a_new.data
    base = out[0]
    for o in out:
        if o["iters"] != expect_iters or o["iters"] != base["iters"]:
            raise AssertionError(f"hot step ({o['mode']}): {o['iters']} "
                                 f"iterations, static {base['iters']}")
        if o["panel_iters"] != base["panel_iters"]:
            raise AssertionError(f"k={TUNE_K} panel ({o['mode']}): "
                                 f"iterations {o['panel_iters']}, static "
                                 f"{base['panel_iters']}")
        for key in ("x", "X"):
            if not torch.equal(o[key], base[key]):
                raise AssertionError(
                    f"{key} ({o['mode']}) not bitwise the static run's "
                    f"(rel {_rel(o[key], base[key]):.3e})")
    summary = dict(order=[o["mode"] for o in out],
                   step_ms=[o["step_ms"] for o in out],
                   panel_ms=[o["panel_ms"] for o in out],
                   iters=base["iters"], panel_iters=base["panel_iters"],
                   solutions="bitwise equal")
    if verbose:
        print("tune steps " + json.dumps(summary))
    return summary


def resolve_cost_us(run: dict, calls: int = 20000) -> dict:
    """Host microseconds per ``resolve_param`` of one level-0 launch
    signature, in each mode (the port resolves at every launch)."""
    from repro_torch.kernels import autotune
    a = run["solver"].hierarchy.levels[0].a_ell
    sig = autotune.signature(a.data.dtype, a.nbr, br=a.br, bc=a.bc,
                             kmax=a.kmax)
    cost = {}
    for mode in ("off", "cache"):
        with tune_mode(mode):
            t0 = time.perf_counter()
            for _ in range(calls):
                autotune.resolve_param("block_spmv", sig, "threads", None,
                                       autotune.DEFAULT_THREADS,
                                       device=a.data.device)
            cost[mode] = 1e6 * (time.perf_counter() - t0) / calls
    return cost


# ---------------------------------------------------------------------------
# The port on the CPU against the port on the card
# ---------------------------------------------------------------------------

def cpu_vs_cuda(m: int, coarse_size: int) -> dict:
    import numpy as np
    import torch
    cpu = main_path(m, "cpu", coarse_size=coarse_size, verbose=False)
    gpu = main_path(m, "cuda", coarse_size=coarse_size, verbose=False)
    s_cpu, s_gpu = cpu["solver"].setup_data, gpu["solver"].setup_data
    if s_cpu.stats["level_rows"] != s_gpu.stats["level_rows"]:
        raise AssertionError(f"levels differ: {s_cpu.stats['level_rows']} vs"
                             f" {s_gpu.stats['level_rows']}")
    for li, (a, b) in enumerate(zip(s_cpu.levels, s_gpu.levels)):
        if not np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            raise AssertionError(f"level {li}: aggregates differ")
    out = dict(level_rows=s_cpu.stats["level_rows"],
               level_bs=s_cpu.stats["level_bs"], iters=[], rel_diff=[])
    for rc, rg in zip(cpu["records"], gpu["records"]):
        if rc["iters"] != rg["iters"]:
            raise AssertionError(f"step {rc['step']}: {rc['iters']} CG "
                                 f"iterations on CPU, {rg['iters']} on CUDA")
        xc, xg = rc["x"], rg["x"].cpu()
        rel = float(torch.linalg.vector_norm(xc - xg)
                    / torch.linalg.vector_norm(xc))
        if not rel <= SOLUTION_TOL:
            raise AssertionError(f"step {rc['step']}: solutions differ by "
                                 f"{rel:.3e}")
        out["iters"].append(rc["iters"])
        out["rel_diff"].append(rel)
    # one k=4 panel solve on each side
    B = np.random.default_rng(4).standard_normal((cpu["prob"].n, 4))
    pc = cpu["solver"].solve_many(torch.as_tensor(B))
    pg = gpu["solver"].solve_many(torch.as_tensor(B, device="cuda"))
    if not torch.equal(pc.iters, pg.iters.cpu()):
        raise AssertionError(f"k=4 panel: iterations {pc.iters.tolist()} on "
                             f"CPU, {pg.iters.tolist()} on CUDA")
    rel = _rel(pg.x, pc.x)
    if not rel <= SOLUTION_TOL:
        raise AssertionError(f"k=4 panel: solutions differ by {rel:.3e}")
    out.update(panel_iters=pc.iters.tolist(), panel_rel_diff=rel)
    return out


def aggregates_vs_cpu(run: dict) -> dict:
    """The card's m=32 setup against the port's on the CPU: levels, nnzb
    and ``n_agg`` equal; where a level's aggregates differ, every
    difference traced back to greedy pass-2 ties within ``TIE_ULPS``,
    judged by the CPU's weights (``trace_tie_flips``)."""
    import numpy as np

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core import gamg
    from repro_torch.core.aggregation import trace_tie_flips
    from repro_torch.core.strength import strength_graph
    from repro_torch.fem.assemble import assemble_elasticity

    cfg = ElasticityConfig(m=MAIN_M)
    t0 = time.perf_counter()
    prob = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               device="cpu")
    cpu = gamg.setup(prob.A, prob.B, theta=cfg.theta,
                     coarse_size=cfg.coarse_size, coarsener=cfg.coarsener)
    setup_s = time.perf_counter() - t0
    card = run["solver"].setup_data
    for key in ("level_rows", "level_nnzb", "level_bs"):
        if cpu.stats[key] != card.stats[key]:
            raise AssertionError(f"m={MAIN_M} {key}: CPU {cpu.stats[key]}, "
                                 f"card {card.stats[key]}")
    tol = TIE_ULPS * float(np.finfo(np.float64).eps)
    levels = []
    for li, (a, b) in enumerate(zip(cpu.levels, card.levels)):
        if a.aggr.n_agg != b.aggr.n_agg:
            raise AssertionError(f"m={MAIN_M} level {li}: n_agg "
                                 f"{a.aggr.n_agg} on CPU, {b.aggr.n_agg} "
                                 f"on the card")
        if np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            levels.append(dict(level=li, differing_nodes=0))
            continue
        out = trace_tie_flips(strength_graph(a.A0, cpu.theta),
                              strength_graph(b.A0, card.theta),
                              -(-cpu.nns_dim // a.A0.br), tol)
        levels.append(dict(level=li, **out))
        if not (out["same_edges"] and out["traced"]):
            raise AssertionError(f"m={MAIN_M} level {li}: aggregates differ "
                                 f"beyond pass-2 ties within {TIE_ULPS} "
                                 f"ulps: {out}")
    return dict(cpu_setup_s=setup_s, tie_rtol=tol, levels=levels,
                differing_nodes=sum(lv["differing_nodes"] for lv in levels),
                max_tie_gap=max(lv.get("max_tie_gap", 0.0)
                                for lv in levels))


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def peaks_for(name: str) -> tuple:
    """The datasheet peaks; another card has other peaks, so it raises."""
    if CARD not in name:
        raise RuntimeError(f"chip_smoke: bounds are for the {CARD} "
                           f"({PEAKS[0] / 1e12} TB/s, {PEAKS[1] / 1e12} "
                           f"TFLOP/s fp64); this card is {name!r}")
    return PEAKS


def kernel_record(per: dict, by_path: dict, per_step: dict,
                  peaks: tuple) -> dict:
    """The per-kernel JSON record: launches summed over the paths (and per
    path), the largest error against the plain version, and times summed
    over the cases."""
    record = []
    for kname, meta in KERNELS.items():
        row = per[kname]
        if row["cases"] == 0:
            raise AssertionError(f"{kname}: no case checked")
        by_bytes = row["bytes"] / peaks[0] >= row["flops"] / peaks[1]
        record.append(dict(
            name=kname, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(p[kname] for p in by_path.values()),
            launches_by_path={path: p[kname] for path, p in by_path.items()},
            launches_per_hot_step=sum(v[kname] for v in per_step.values()),
            cases=row["cases"], max_abs_err=row["max_abs_err"],
            max_rel_err=row["max_rel_err"], ms=row["ms"],
            kernel_ms=row["ms"], ms_single=row["ms_single"],
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"],
            bound_by="bytes" if by_bytes else "operations",
            library_ms=row["library_ms"] if row["library_all"] else None))
    return {"kernels": record}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tune_dir) /
                                               "autotune.json")
    try:
        with tune_mode("off"):
            return run_all()
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_all() -> int:
    import torch

    from repro_torch.kernels import autotune, backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}")
    peaks = peaks_for(name)

    t0 = time.perf_counter()
    so = backend.build_library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s -> {so.name}")
    log = Path(str(so) + ".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("ptxas " + ln.strip())

    reset_counts()
    with SignatureLog() as sigs:
        run = main_path(MAIN_M, "cuda")
        by_path = {"main": read_counts()}
        check_main_path(run)
        per_step = run["records"][-1]["launches"]
        print("main path launches " + json.dumps(by_path["main"]))
        print("launches per hot step " + json.dumps(per_step))
        print("coarse operators " + json.dumps(check_fingerprint(run)))
        profile_hot_step(run)

        by_path["serve"] = serve_path(run, "cuda", EXPECT_ITERS)
    check_path_launches("serve", by_path["serve"],
                        ("block_spmm", "fused_smoother", "block_spmv"))
    by_path["pairs"] = pairs_path(run, "cuda", EXPECT_ITERS)
    check_path_launches("pairs", by_path["pairs"],
                        ("block_pair_gemm", "block_seg_sum"))

    print("bitwise per column " + json.dumps(check_bitwise(run, "cuda")))
    print(f"datasheet peaks: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.1f} TFLOP/s fp64; measured copy_ "
          f"{copy_bandwidth() / 1e12:.3f} TB/s")
    cases = build_cases(run, "cuda")
    per = check_kernels(cases, peaks)
    lanes_sweep(cases)

    by_path["tune"], _ = tune_path(run, sigs.seen, "cuda")
    check_path_launches("tune", by_path["tune"], TUNED)
    print("threads bitwise " + json.dumps(check_threads_bitwise(cases)))
    rows = tuned_vs_static_kernels(cases)
    slower = [r for r in rows if r["beyond_margin"]]
    print("tune winners slower than 256 beyond the margin " + json.dumps(
        dict(margin=autotune.EVENT_MARGIN, count=len(slower), of=len(rows),
             cases=[f"{r['kernel']} {r['case']}" for r in slower])))
    print("tune resolve host us per call "
          + json.dumps(resolve_cost_us(run)))
    tuned_vs_static_steps(run, "cuda", EXPECT_ITERS)
    with tune_mode("cache"):
        profile_hot_step(run, label="tuned ")

    check = cpu_vs_cuda(CHECK_M, CHECK_COARSE)
    print("cpu vs cuda " + json.dumps(check))
    print(f"m={MAIN_M} aggregates card vs cpu "
          + json.dumps(aggregates_vs_cpu(run)))

    print(json.dumps(kernel_record(per, by_path, per_step, peaks)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
