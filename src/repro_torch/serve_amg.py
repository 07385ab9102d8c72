"""Serve AMG: the hierarchy-reusing multi-RHS solve server, end to end
(torch twin of ``examples/serve_amg.py``).

One cold GAMG setup serves a *stream* of solve requests (load cases,
client queries, Newton steps).  The server buckets arriving right-hand
sides into static panel widths (k in {1, 2, 4, 8} here), pads the
remainder columns with zeros (frozen from iteration 0 by the masked PCG),
and runs batched panel solves on the cached hierarchy (on CUDA through
``block_spmm`` and the panel ``fused_smoother``); each request gets its
own iteration count and residual back, identical to a dedicated solve.
The setting is the reference example's: device assembly, the MIS
coarsener, ``coarse_size=40``; the requests are drawn on the host from
``np.random.default_rng(0)``, so they are bitwise the reference's.

Run:  PYTHONPATH=src python -m repro_torch.serve_amg [m] [--device cpu]

``m`` defaults to 7; the device to ``cuda``, which raises without a card.
The last line is one JSON object: levels, per burst the buckets and
per-request iterations, the post-update iterations and the server stats.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import gamg
from repro_torch.fem.assemble import assemble_elasticity
from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.multirhs import AMGSolveServer

BUCKETS = (1, 2, 4, 8)
#: arrival counts, deliberately off-bucket
BURSTS = (1, 3, 8, 5)
POST_UPDATE = 4          # copies of b served after the operator update


def main(m: int = 7, device="cuda") -> dict:
    """Run the session; the result's ``solutions`` (per burst, then the
    post-update burst, one numpy array a request) stay out of the CLI's
    JSON line."""
    dev = resolve_device(device)
    print(f"assembling {m}^3 Q1 elasticity on {dev} ...")
    prob = assemble_elasticity(m, device=dev)
    t0 = time.perf_counter()
    setupd = gamg.setup(prob.A, prob.B, coarse_size=40)
    server = AMGSolveServer(setupd, prob.A.data, buckets=BUCKETS,
                            rtol=1e-8, maxiter=100)
    sync(dev)
    print(f"cold setup + hierarchy: {time.perf_counter() - t0:.2f}s, "
          f"n = {prob.n}, buckets = {server.buckets}, "
          f"precision: {setupd.precision.describe()}")

    rng = np.random.default_rng(0)
    bursts, solutions = [], []
    for burst in BURSTS:
        for _ in range(burst):
            server.submit(rng.standard_normal(prob.n))
        t0 = time.perf_counter()
        reports = server.flush()        # returns host arrays: synchronised
        dt = time.perf_counter() - t0
        its = [r.iters for r in reports]
        ok = all(r.converged for r in reports)
        bursts.append(dict(requests=burst,
                           buckets=sorted({r.k_bucket for r in reports}),
                           k_bucket=[r.k_bucket for r in reports],
                           iters=its, converged=ok, ms=dt * 1e3))
        solutions.append([r.x for r in reports])
        print(f"burst of {burst}: buckets {bursts[-1]['buckets']} | iters "
              f"{min(its)}-{max(its)} | {dt * 1e3:7.1f} ms total | "
              f"{dt * 1e3 / burst:6.1f} ms/rhs | all converged: {ok}")

    # operator update mid-stream (a Newton step): hierarchy structure and
    # the bucket solves are reused, only the values recompute
    a_new = prob.reassemble(1.2)
    t0 = time.perf_counter()
    server.update_operator(a_new.data)
    sync(dev)
    update_ms = (time.perf_counter() - t0) * 1e3
    print(f"hot operator update: {update_ms:.1f} ms")
    b = prob.b.cpu().numpy()
    reports = server.serve([b for _ in range(POST_UPDATE)])
    post = [r.iters for r in reports]
    solutions.append([r.x for r in reports])
    print(f"post-update burst: iters {post}")
    print(f"stats: {server.stats}")
    if not all(r.converged for r in reports):
        raise AssertionError(f"serve_amg m={m}: a post-update request did "
                             f"not converge: iters {post}")
    return dict(m=m, device=str(dev),
                level_rows=setupd.stats["level_rows"], bursts=bursts,
                update_ms=update_ms, post_update_iters=post,
                stats=server.stats, solutions=solutions)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_amg",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=7,
                    help="elements per edge of the cube (default 7)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = main(args.m, args.device)
    del out["solutions"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
