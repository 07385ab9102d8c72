"""Heterogeneous quasi-static loop: device assembly + coefficient updates
(torch twin of ``examples/heterogeneous.py``).

A two-material problem (stiff spherical inclusion in a soft matrix) whose
inclusion stiffness ramps over "load steps" (contrasts 1, 10, 100 and
1000).  Each step runs the device hot loop: per-element material fields
in, batched quadrature and the cached blocked-COO scatter
(``block_seg_sum``), the state-gated PtAP recompute, then the solve; no
per-step host assembly and no value-stream upload.  The setting is the
reference example's: device assembly, the MIS coarsener,
``coarse_size=40``.

The reference asserts that one traced program served every step.  Torch
traces nothing, so this twin holds what that assertion protects: each
update copies exactly the two per-element fields to the card
(``2 * n_elements * 8`` bytes, counted at the aten level by
``obs.transfer.count_h2d``; 0 on the CPU) and nothing else, and the
solver keeps the same setup object throughout.  The update's ms include
that count's dispatch-mode overhead (its one-time import is paid before
the first step).

Run:  PYTHONPATH=src python -m repro_torch.heterogeneous [m] [--device cpu]

``m`` defaults to 7; the device to ``cuda``, which raises without a card.
The last line is one JSON object: levels, per step the iterations, the
host-to-device bytes and the update and solve ms.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import gamg
from repro_torch.fem.assemble import assemble_elasticity, inclusion_fields
from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.obs.transfer import count_h2d

CONTRASTS = (1.0, 10.0, 100.0, 1000.0)


def main(m: int = 7, device="cuda") -> dict:
    """Run the ramp; the result's ``solutions`` (one numpy array a step)
    stay out of the CLI's JSON line."""
    dev = resolve_device(device)
    print(f"assembling {m}^3 Q1 elasticity on {dev} (batched quadrature)")
    prob = assemble_elasticity(m, device=dev)     # path="device" default
    ne = prob.mesh.n_elements
    field_bytes = 2 * ne * 8
    want_h2d = field_bytes if dev.type == "cuda" else 0
    print(f"  n = {prob.n} unknowns, {ne} elements, coefficient update "
          f"payload = {field_bytes} bytes (vs "
          f"{prob.values.numel() * prob.values.element_size()} "
          f"value-stream bytes)")

    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=40,
                             rtol=1e-8, maxiter=100)
    solver.bind_assembler(prob.assembler)
    setupd = solver.setup_data
    print(f"cold setup: {setupd.n_levels} levels, "
          f"rows/level = {setupd.stats['level_rows']}")

    # the count's first op under a dispatch mode imports torch's dispatch
    # machinery (seconds): pay it before any clock starts
    count_h2d(lambda: torch.zeros(1, device=dev) + 1)
    steps, solutions = [], []
    for step, contrast in enumerate(CONTRASTS):
        E, nu = inclusion_fields(prob.mesh, E_inclusion=contrast)
        sync(dev)
        t0 = time.perf_counter()
        _, h2d, copies = count_h2d(lambda: solver.update_coefficients(E, nu))
        sync(dev)
        t_up = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = solver.solve(prob.b)
        sync(dev)
        t_solve = time.perf_counter() - t0
        iters = int(res.iters)
        print(f"step {step}: E_inclusion {contrast:7.1f} | "
              f"update {t_up * 1e3:7.1f} ms | solve {t_solve * 1e3:7.1f} ms"
              f" | iters {iters:3d} | relres {float(res.relres):.2e} | "
              f"h2d {h2d} B")
        steps.append(dict(contrast=contrast, iters=iters,
                          relres=float(res.relres), h2d_bytes=h2d,
                          h2d_copies=copies, update_ms=t_up * 1e3,
                          solve_ms=t_solve * 1e3))
        solutions.append(res.x.cpu().numpy())
        if not bool(res.converged):
            raise AssertionError(f"heterogeneous step {step} (contrast "
                                 f"{contrast}) did not converge")
        if h2d != want_h2d or solver.setup_data is not setupd:
            raise AssertionError(
                f"heterogeneous step {step}: {h2d} bytes host to device in "
                f"{copies} copies (expected {want_h2d}: the two fields), "
                f"same setup: {solver.setup_data is setupd}")
    print(f"converged; every update copied {want_h2d} bytes to {dev}.")
    return dict(m=m, device=str(dev), level_rows=setupd.stats["level_rows"],
                n_elements=ne, field_bytes=field_bytes,
                iters=[s["iters"] for s in steps], steps=steps,
                solutions=solutions)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.heterogeneous",
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
