"""CLI for the kernel launch autotuner.

    python -m repro_torch.kernels.autotune smoke [--device cuda|cpu]
        One small sweep (block_spmv, 3x3/f64, kmax 4, 32 block rows), then
        clear the in-process memo, reload the cache from disk and assert
        the winner round-trips.  ``--device cpu`` times the plain versions
        (the CPU tests run it); the default is the card, and without one
        it raises.

    python -m repro_torch.kernels.autotune sweep [--family F] [--nbr N]
            [--device cuda|cpu]
        Sweep the elasticity signatures (3x3, 3x6 and 6x6 blocks, f64) at
        N block rows for one family or all of them, recording winners
        into the cache.

    python -m repro_torch.kernels.autotune show [--device cuda|cpu]
        Print the cache for this machine and device kind.

The cache is ``REPRO_TORCH_TUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kernels import autotune


def _smoke(device: str) -> int:
    sig = autotune.signature("float64", 32, br=3, bc=3, kmax=4)
    won = autotune.sweep("block_spmv", sig, repeats=2, device=device)
    autotune.clear_memo()
    reloaded = autotune.lookup("block_spmv", sig, "threads", device=device)
    if reloaded != won["params"]["threads"]:
        print(f"FAIL: cache round-trip: swept {won['params']['threads']}, "
              f"reloaded {reloaded}")
        return 1
    resolved = autotune.resolve_param("block_spmv", sig, "threads", None,
                                      autotune.DEFAULT_THREADS,
                                      device=device)
    print(f"autotune smoke OK: {autotune.entry_key('block_spmv', sig)} -> "
          f"threads={reloaded} ({won['best_us']:.1f} us) on "
          f"{autotune.machine_key(device)}, cache at "
          f"{autotune.cache_path()}, resolve={resolved}")
    return 0


def _sweep(family: str | None, nbr: int, device: str) -> int:
    f64 = "float64"
    blocks = ((3, 3), (3, 6), (6, 6))
    sigs = {
        "block_spmv": [autotune.signature(f64, nbr, br=br, bc=bc, kmax=8)
                       for br, bc in blocks],
        "block_spmm": [autotune.signature(f64, nbr * 8, br=br, bc=bc,
                                          kmax=8, k=8)
                       for br, bc in blocks],
        "pbjacobi": [autotune.signature(f64, nbr * bs, bs=bs)
                     for bs in (3, 6)],
        "fused_smoother": [autotune.signature(f64, nbr, br=bs, bc=bs, kmax=8)
                           for bs in (3, 6)],
        "fused_pair_gemm": [autotune.signature(f64, nbr * br * bc, br=br,
                                               bk=bk, bc=bc, kmax=8)
                            for br, bk, bc in ((3, 3, 6), (6, 3, 6),
                                               (6, 6, 6))],
    }
    fams = [family] if family else sorted(sigs)
    for fam in fams:
        for sig in sigs[fam]:
            won = autotune.sweep(fam, sig, device=device)
            print(f"{autotune.entry_key(fam, sig)} -> {won['params']} "
                  f"({won['best_us']:.1f} us)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.kernels.autotune")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd in ("smoke", "sweep", "show"):
        p = sub.add_parser(cmd)
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        if cmd == "sweep":
            p.add_argument("--family", choices=sorted(autotune.CANDIDATES),
                           default=None)
            p.add_argument("--nbr", type=int, default=256)
    args = ap.parse_args(argv)
    if args.cmd == "smoke":
        return _smoke(args.device)
    if args.cmd == "sweep":
        return _sweep(args.family, args.nbr, args.device)
    key = autotune.machine_key(args.device)
    print(json.dumps({key: autotune.load_cache().get(key, {})}, indent=1,
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
