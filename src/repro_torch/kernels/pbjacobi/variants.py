"""pbjacobi variants against the kept kernel, on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.pbjacobi.variants

At the main path's three ``dinv`` shapes (``ElasticityConfig(m=32)`` on
the host assembly path and the greedy coarsener: (31744, 3, 3), (1331, 6,
6), (836, 6, 6)) it times, in turns (each variant once forward and once
backward through the list; device ms per call as ``autotune.device_ms``
takes them):

- ``first path``: the first port's call, omega written to the card by a
  ``torch.full`` launch and read there by the kernel (two launches);
- ``first kernel``: that kernel alone, omega already on the card;
- ``staged`` / ``staged, one wave of 256``: the shared-memory variant of
  ``variants.cu`` with rows per CTA spread over the SMs, and at 256
  threads' worth of rows a CTA;
- ``kept``: the kept kernel, omega by value (``pbjacobi_update`` with a
  number).

Each variant's output must be bitwise the kept kernel's.  Beside each it
prints the empty kernel (``csrc/launch_floor.cu``) at the variant's grid
and the byte bound at 3.35 TB/s.  Last line: the card's name and power
limit as ``nvidia-smi`` gives them.  Builds ``variants.cu`` with the
library's ``nvcc`` flags into the git-ignored build directory.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import backend

OMEGA = 0.6
THREADS = 256
BANDWIDTH = 3.35e12          # H100 SXM datasheet HBM3 rate
_SRC = Path(__file__).resolve().with_name("variants.cu")


def _variant_lib() -> ctypes.CDLL:
    so = backend.BUILD_DIR / "libpbjacobi_variants.so"
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([backend._nvcc(), *backend.NVCC_FLAGS, "-I",
                          str(backend.CSRC), "-shared", "-o", str(so),
                          str(_SRC)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {_SRC.name}:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_pbjacobi_staged_f64
    fn.argtypes = [backend.P] * 4 + [backend.D, backend.P] \
        + [backend.I] * 3 + [backend.P]
    fn.restype = ctypes.c_int
    return fn


def _dinv_cases():
    """The main path's dinv per level, with seeded r and x."""
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.fem.assemble import assemble_elasticity
    prob = assemble_elasticity(32, path="host", device="cuda")
    solver = GAMGSolver(prob.A, prob.B, coarse_size=100, coarsener="greedy")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for li, lv in enumerate(solver.hierarchy.levels):
        if lv.dinv is None:
            continue
        nbr, bs = lv.dinv.shape[0], lv.dinv.shape[1]
        r, x = (torch.randn(nbr, bs, generator=gen, dtype=torch.float64,
                            device="cuda") for _ in range(2))
        cases.append((f"L{li} dinv ({nbr},{bs},{bs})", lv.dinv, r, x))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("pbjacobi variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.autotune import device_ms, launch_floor_ms
    from repro_torch.kernels.pbjacobi.ops import pbjacobi_update

    staged = _variant_lib()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    summary = {}
    for label, dinv, r, x in _dinv_cases():
        nbr, bs = dinv.shape[0], dinv.shape[1]
        w_dev = torch.full((1,), OMEGA, dtype=torch.float64, device="cuda")

        def run_staged(rows, dinv=dinv, r=r, x=x, nbr=nbr, bs=bs):
            out = torch.empty_like(x)
            rc = staged(dinv.data_ptr(), r.data_ptr(), x.data_ptr(), None,
                        OMEGA, out.data_ptr(), nbr, bs, rows,
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"staged variant: CUDA error {rc}")
            return out

        one_wave = THREADS // bs
        spread = max(1, min(one_wave, -(-nbr // n_sm)))
        first_grid = [-(-nbr * bs // THREADS), THREADS]
        variants = {
            "first path": (lambda: pbjacobi_update(
                dinv, r, x, torch.full((1,), OMEGA, dtype=torch.float64,
                                       device="cuda"), threads=THREADS),
                first_grid),
            "first kernel": (lambda: pbjacobi_update(
                dinv, r, x, w_dev, threads=THREADS), first_grid),
            "staged": (lambda: run_staged(spread),
                       [-(-nbr // spread), spread * bs]),
            "staged, one wave of 256": (lambda: run_staged(one_wave),
                                        [-(-nbr // one_wave), one_wave * bs]),
            "kept": (lambda: pbjacobi_update(dinv, r, x, OMEGA,
                                             threads=THREADS), first_grid),
        }
        want = variants["kept"][0]()
        for name, (fn, _) in variants.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{label}: {name} is not bitwise the "
                                     f"kept kernel")
        order = list(variants) + list(reversed(variants))
        times = {name: [] for name in variants}
        for name in order:
            times[name].append(device_ms(variants[name][0]))
        nbytes = (nbr * bs * bs + 3 * nbr * bs) * 8
        row = dict(case=label, bound_ms=1e3 * nbytes / BANDWIDTH,
                   variants={name: dict(
                       ms=sum(times[name]) / 2, turns=times[name],
                       grid=grid, floor_ms=launch_floor_ms(*grid))
                       for name, (_, grid) in variants.items()})
        print("pbjacobi variants " + json.dumps(row))
        for name in variants:
            summary[name] = summary.get(name, 0.0) \
                + row["variants"][name]["ms"]
    print("pbjacobi variants sum ms " + json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
