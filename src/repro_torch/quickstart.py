"""Quickstart: blocked AMG on 3D elasticity, the paper's workflow (torch
twin of ``examples/quickstart.py``).

Assembles a Q1 hex elasticity operator through the blocked COO primitive
(device assembly), builds the GAMG hierarchy once with the reference's
defaults (the device Luby-MIS coarsener, ``coarse_size=40``), then runs
the production loop: the operator changes every "Newton step", the
hierarchy is reused, and the hot PtAP recompute and the AMG-PCG solve run
on the device in blocks (on CUDA through the port's kernels).

Run:  PYTHONPATH=src python -m repro_torch.quickstart [m] [--device cpu]

``m`` defaults to 9; the device to ``cuda``, which raises without a card.
The last line is one JSON object: levels, iterations per step, and
whether the last step converged.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import gamg
from repro_torch.fem.assemble import assemble_elasticity
from repro_torch.kernels.backend import resolve_device, sync


def main(m: int = 9, device="cuda", steps: int = 3) -> dict:
    dev = resolve_device(device)
    print(f"assembling {m}^3 Q1 elasticity via blocked COO on {dev} ...")
    prob = assemble_elasticity(m, device=dev)
    print(f"  n = {prob.n} unknowns, {prob.A.nnzb} 3x3 blocks, "
          f"COO plan {prob.coo_plan.plan_bytes / 1e6:.2f} MB")

    t0 = time.perf_counter()
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=40, rtol=1e-8,
                             maxiter=100)
    sync(dev)
    stats = solver.setup_data.stats
    print(f"cold setup: {time.perf_counter() - t0:.2f}s, "
          f"{solver.setup_data.n_levels} levels, "
          f"rows/level = {stats['level_rows']}, "
          f"bs/level = {stats['level_bs']}")

    # production loop: operator changes, hierarchy (aggregates + P) reused
    iters = []
    for step in range(steps):
        scale = 1.0 + 0.1 * step           # stand-in for a Newton update
        a_new = prob.reassemble(scale)     # one MatSetValuesCOO scatter
        t0 = time.perf_counter()
        solver.update_operator(a_new.data)  # hot PtAP chain
        sync(dev)
        t_ptap = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = solver.solve(prob.b)
        sync(dev)
        t_solve = time.perf_counter() - t0
        iters.append(int(res.iters))
        print(f"step {step}: hot PtAP {t_ptap * 1e3:7.1f} ms | "
              f"hot KSPSolve {t_solve * 1e3:7.1f} ms | "
              f"iters {int(res.iters):3d} | relres {float(res.relres):.2e}")
    out = dict(m=m, device=str(dev), level_rows=stats["level_rows"],
               iters=iters, converged=bool(res.converged))
    if not out["converged"]:
        raise AssertionError(f"quickstart m={m}: the last step did not "
                             f"converge (relres {float(res.relres):.3e})")
    print("converged.")
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=9,
                    help="elements per edge of the cube (default 9)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.m, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
