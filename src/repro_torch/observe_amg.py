"""Observe AMG: the full telemetry surface around one serving session
(torch twin of ``examples/observe_amg.py``).

Drives every layer of ``repro_torch.obs`` against a live solve server:

* ``counters`` mode: a device-side ``CycleTally`` rides the CG carry, so
  the solve itself reports what it did (per-level visits, smoother /
  operator / coarse applications) and what the traffic model says it
  should have cost; held here to the analytic count (``iters + 1``
  cycles, ``2 * cycles`` smoother sweeps a level, ``cycles`` coarse
  solves);
* per-request residual **histories** (NaN-padded per-column traces) from
  the panel solve;
* the server's always-on ``ServerMetrics``: queue wait, end-to-end
  latency, blocked solve wall time, padding efficiency, per-bucket and
  per-status counts, polled through ``snapshot()`` and exported as
  Prometheus text and as JSONL lines;
* the ``measure()`` first-call/steady split on the hot recompute: the
  first call files under ``recompute/compile`` (the reference's name; in
  torch it is the cold call, which pays first-use costs), the rest under
  ``recompute/steady``.

The setting is the reference example's: device assembly, the MIS
coarsener, ``coarse_size=40``, bursts of 3, 8 and 1 requests from
``np.random.default_rng(0)``.

Run:  PYTHONPATH=src python -m repro_torch.observe_amg [m] [--device cpu]

``m`` defaults to 6; the device to ``cuda``, which raises without a card.
The last line is one JSON object: the tally, the history's marks, the
snapshot, the recompute split and the exported instrument names.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import gamg
from repro_torch.fem.assemble import assemble_elasticity
from repro_torch.kernels.backend import resolve_device
from repro_torch.multirhs import AMGSolveServer
from repro_torch.obs import MetricsRegistry, describe_tally, \
    parse_prometheus, use

BURSTS = (3, 8, 1)
SCALES = (1.0, 1.1, 1.2)
#: the snapshot keys the reference prints
SNAPSHOT_KEYS = ("requests", "batches", "padded_columns",
                 "padding_efficiency", "solves_per_k", "status",
                 "latency_p50_s", "latency_p99_s", "solve_wall_p50_s")
PROM_EXCERPT = ("server_request_latency_seconds_count",
                "server_padding_efficiency", "server_batches_total")


def _tally_dict(tally) -> dict:
    return {k: v.cpu().tolist() for k, v in tally._asdict().items()}


def check_tally(tally, iters: int) -> int:
    """Hold a counters-mode vector solve's tally to the analytic count;
    returns the number of cycles."""
    cycles = iters + 1
    t = _tally_dict(tally)
    nl = len(t["level_visits"])
    want = dict(level_visits=[cycles] * nl, smoother_applies=[2 * cycles]
                * nl, coarse_solves=cycles, precond_applies=cycles)
    bad = {k: (t[k], v) for k, v in want.items() if t[k] != v}
    if bad:
        raise AssertionError(f"tally against the analytic count "
                             f"({cycles} cycles): {bad}")
    return cycles


def main(m: int = 6, device="cuda") -> dict:
    """Run the session; the result's ``history`` (the request's
    NaN-padded residual trace, numpy) stays out of the CLI's JSON line."""
    dev = resolve_device(device)
    print(f"assembling {m}^3 Q1 elasticity on {dev} ...")
    prob = assemble_elasticity(m, device=dev)
    setupd = gamg.setup(prob.A, prob.B, coarse_size=40)
    print(f"hierarchy: {setupd.n_levels} levels, n = {prob.n}, "
          f"precision: {setupd.precision.describe()}")

    # ---- device-side counters on a single solve -------------------------
    # the obs mode binds when the closure is built: build it in the scope
    with use("counters"):
        solve = gamg.make_solve(setupd, rtol=1e-8, maxiter=100)
    hier = gamg.make_recompute(setupd)(prob.A.data)
    res = solve(hier, prob.b)
    iters = int(res.iters)
    line = describe_tally(res.counters)
    print(f"\nsolve: {iters} iters, relres {float(res.relres):.2e}")
    print(f"tally: {line}")
    cycles = check_tally(res.counters, iters)
    print(f"check: {cycles} cycles -> {cycles} V-cycles, {2 * cycles} "
          f"smoother sweeps/level, {cycles} coarse solves")

    # ---- server metrics + per-request histories -------------------------
    server = AMGSolveServer(setupd, prob.A.data, buckets=(1, 2, 4, 8),
                            rtol=1e-8, maxiter=100, record_history=True)
    rng = np.random.default_rng(0)
    flushed = []
    for burst in BURSTS:
        for _ in range(burst):
            server.submit(rng.standard_normal(prob.n))
        flushed.append([[r.k_bucket, r.iters] for r in server.flush()])
    r = server.serve([prob.b.cpu().numpy()])[0]
    live = r.history[np.isfinite(r.history)]
    marks = [0, len(live) // 2, len(live) - 1]
    print(f"\nresidual history (request {r.request_id}, {r.iters} iters, "
          f"latency {r.latency_s * 1e3:.1f} ms):")
    print("  " + "  ".join(f"it{k:>3}: {live[k]:.2e}" for k in marks))
    snap = server.snapshot()
    print("\nserver snapshot:")
    for key in SNAPSHOT_KEYS[:6]:
        print(f"  {key:>20}: {snap[key]}")
    print(f"  {'latency p50/p99':>20}: {snap['latency_p50_s'] * 1e3:.1f} / "
          f"{snap['latency_p99_s'] * 1e3:.1f} ms")
    print(f"  {'solve wall p50':>20}: {snap['solve_wall_p50_s'] * 1e3:.1f} ms")

    # ---- first-call/steady split on the hot recompute -------------------
    reg = MetricsRegistry()
    recompute = gamg.make_recompute(setupd)
    for scale in SCALES:
        reg.measure("recompute", recompute, scale * prob.A.data)
    cold = reg.get("recompute/compile").snapshot()
    hot = reg.get("recompute/steady").snapshot()
    print(f"\nrecompute: first call {cold['max'] * 1e3:.1f} ms "
          f"(x{cold['count']}), steady {hot['max'] * 1e3:.1f} ms "
          f"(x{hot['count']})")

    # ---- exporters ------------------------------------------------------
    prom = server.metrics().to_prometheus()
    print("\nprometheus exposition (excerpt):")
    for ln in prom.splitlines():
        if ln.startswith(PROM_EXCERPT):
            print(f"  {ln}")
    jsonl = server.metrics().to_jsonl()
    print(f"jsonl export: {len(jsonl.splitlines())} instrument lines")
    return dict(
        m=m, device=str(dev), level_rows=setupd.stats["level_rows"],
        iters=iters, cycles=cycles, tally=_tally_dict(res.counters),
        tally_line=line, bursts=flushed,
        request=dict(id=r.request_id, iters=r.iters, k_bucket=r.k_bucket,
                     history_len=int(len(live)),
                     marks=[float(live[k]) for k in marks]),
        snapshot={k: snap[k] for k in SNAPSHOT_KEYS},
        recompute={"compile": dict(count=cold["count"],
                                   max_ms=cold["max"] * 1e3),
                   "steady": dict(count=hot["count"],
                                  max_ms=hot["max"] * 1e3)},
        prometheus=sorted(parse_prometheus(prom)),
        jsonl_lines=len(jsonl.splitlines()), history=r.history)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.observe_amg",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=6,
                    help="elements per edge of the cube (default 6)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = main(args.m, args.device)
    del out["history"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
