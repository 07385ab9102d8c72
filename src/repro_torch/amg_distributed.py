"""Distributed AMG: the paper's production solve on N ranks (torch twin of
``examples/amg_distributed.py``).

Runs ``python -m repro_torch.dist.selftest`` (row slabs, halo exchanges,
the distributed PtAP and AMG-PCG on ``torch.distributed``) as a child
process in the reference selftest's setting: the MIS coarsener and
``coarse_size=30``, parity with the single-device solve.  On the card a
single rank takes the NCCL backend; several ranks take gloo, which stages
every halo through host memory, so all of them can share one card (NCCL
cannot put two ranks on one GPU).  The reference's section switches
carry over: ``REPRO_SELFTEST_MRHS``, ``_AGG``, ``_COEFF``, ``_MARCH``,
``_OVERLAP`` and ``_FAULT`` set to ``1`` add the selftest's ``--mrhs``,
``--agg``, ``--coeff``, ``--march``, ``--overlap`` and ``--fault``.

Run:  PYTHONPATH=src python -m repro_torch.amg_distributed [world] [m] \\
          [--device cpu]

``world`` defaults to 8 and ``m`` to 6; the device to ``cuda``, which
raises without a card.  Exits with the selftest's return code; its last
lines are ``dist result {...}`` and ``OK``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels.backend import resolve_device

#: the reference's environment switches -> the port selftest's flags
SECTIONS = {"REPRO_SELFTEST_MRHS": "--mrhs", "REPRO_SELFTEST_AGG": "--agg",
            "REPRO_SELFTEST_COEFF": "--coeff",
            "REPRO_SELFTEST_MARCH": "--march",
            "REPRO_SELFTEST_OVERLAP": "--overlap",
            "REPRO_SELFTEST_FAULT": "--fault"}
SRC = Path(__file__).resolve().parents[1]


def command(world: int = 8, m: int = 6, device="cuda") -> list:
    """The selftest's command line for ``world`` ranks at ``m``."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and world == 1 else "gloo"
    cmd = [sys.executable, "-m", "repro_torch.dist.selftest", str(m),
           "--world", str(world), "--backend", backend, "--device",
           dev.type, "--coarsener", "mis", "--coarse-size", "30"]
    return cmd + [flag for var, flag in SECTIONS.items()
                  if os.environ.get(var) == "1"]


def main(world: int = 8, m: int = 6, device="cuda") -> int:
    cmd = command(world, m, device)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(SRC) if not path
               else str(SRC) + os.pathsep + path)
    return subprocess.run(cmd, env=env).returncode


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.amg_distributed",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("world", type=int, nargs="?", default=8,
                    help="rank processes (default 8)")
    ap.add_argument("m", type=int, nargs="?", default=6,
                    help="elements per edge of the cube (default 6)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return main(args.world, args.m, args.device)


if __name__ == "__main__":
    raise SystemExit(cli())
