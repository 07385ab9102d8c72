"""Device-resident quasi-static time march with adaptive re-coarsening
(torch twin of ``examples/march.py``).

Marches the built-in damage-softening scenario (``repro_torch.sim``):
each step feeds the previous solution into the coefficient law, runs
device assembly -> state-gated PtAP recompute -> warm-started AMG-PCG,
and the device staleness monitor decides when the frozen hierarchy has
degraded enough to rebuild.  The three policies run on the same
trajectory:

* ``frozen``    one setup for the whole march;
* ``adaptive``  frozen segments cut by the staleness monitor;
* ``resetup``   a full ``gamg.setup`` before every step (the baseline).

Run:  PYTHONPATH=src python -m repro_torch.march [m] [n_steps] [--device cpu]

``m`` defaults to 5 and ``n_steps`` to 8 (the reference's acceptance
setting: rate 0.25, ``coarse_size=8``, the MIS coarsener); the device to
``cuda``, which raises without a card.  The last line is one JSON object:
per mode the status, setups, iterations and segments, then the adaptive
final state's relative difference from ``resetup``'s.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.fem.assemble import assemble_elasticity
from repro_torch.kernels.backend import resolve_device
from repro_torch.sim import (
    MarchConfig,
    SofteningScenario,
    StalenessConfig,
    march,
)

MODES = ("frozen", "adaptive", "resetup")
SETUP_OPTS = {"coarse_size": 8}     # the reference example's


def main(m: int = 5, n_steps: int = 8, device="cuda") -> dict:
    dev = resolve_device(device)
    print(f"assembling {m}^3 Q1 elasticity on {dev}")
    prob = assemble_elasticity(m, device=dev)
    scen = SofteningScenario.build(prob, rate=0.25, d_max=0.99)
    cfg = MarchConfig(n_steps=n_steps, seg_len=8, rtol=1e-8, maxiter=400,
                      staleness=StalenessConfig(iter_drift=2, ref_window=2,
                                                coeff_rtol=0.25))
    results, out = {}, {"m": m, "n_steps": n_steps, "device": str(dev)}
    for mode in MODES:
        t0 = time.perf_counter()
        res = march(prob, scen, cfg, mode=mode, setup_opts=SETUP_OPTS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        results[mode] = res
        segs = [f"{s.steps}@setup{s.setup_id}({s.reason})"
                for s in res.segments]
        print(f"{mode:>8}: {dt:6.1f} s | setups {res.n_setups} | "
              f"iters {res.iters.tolist()} (total {res.total_iters}) | "
              f"segments: {' '.join(segs)}")
        if res.status != "ok":
            raise AssertionError(f"march {mode}: status {res.status}")
        out[mode] = dict(status=res.status, setups=res.n_setups,
                         iters=res.iters.tolist(), segments=segs,
                         seconds=dt)
    frozen, adaptive, resetup = (results[k] for k in MODES)
    x_ref = resetup.x
    rel = float(torch.linalg.vector_norm(adaptive.x - x_ref)
                / torch.linalg.vector_norm(x_ref))
    print(f"adaptive vs per-step-resetup final state: rel diff {rel:.2e} "
          f"with {adaptive.n_setups}/{resetup.n_setups} of the setups")
    print(f"adaptive vs frozen total CG iterations: "
          f"{adaptive.total_iters} vs {frozen.total_iters}")
    out["adaptive_vs_resetup"] = rel
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.march",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=5,
                    help="elements per edge of the cube (default 5)")
    ap.add_argument("n_steps", type=int, nargs="?", default=8,
                    help="march steps (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.m, args.n_steps, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
