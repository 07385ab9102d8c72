"""Distributed-AMG dry-run rows (torch twin of
``repro.launch.dryrun_amg``): the paper's own solver on the production
device counts, and on the card.

The reference lowers the distributed hot path (recompute, then the
AMG-preconditioned CG) over 256 and 512 placeholder TPU devices.  Here the
same setup (``assemble_elasticity(m)``, ``gamg.setup(..., coarse_size=60)``,
the MIS coarsener) is staged on the host for those rank counts
(``build_dist_gamg``): each ``single`` / ``multi`` row records the grid,
the halo strategy, the placement, one rank's staged bytes
(``argument_bytes``: its ``rank_args``, fine payload slab and ``b``
slab; ``argument_bytes_by_leaf`` names each) and, as ``collectives``,
one V-cycle's messages and bytes from the comm model
(``obs.model.dist_cycle_comm``).  The ``card`` row runs the hot path
for real: ``make_dist_solver`` at world size 1 (NCCL on the card, gloo on
the CPU), its iterations and solution against the single-device solve's,
the hot step's wall ms, the device peak, and ``true_relres``: the
solution's residual ``|b - A x| / |b|`` by the plain block-CSR product on
the CPU (``core.spmv.spmv_bcsr_ref``), which no kernel computes.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import statistics
import tempfile
import time
import traceback

import torch

from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.launch.dryrun import (
    _load_results,
    _nbytes,
    _save_results,
    card_line,
)

#: the ranks of the reference's two production meshes
RANKS = (("single", 256), ("multi", 512))
RTOL = 1e-8
MAXITER = 100
#: timed hot steps of the card row (after one warm-up)
CARD_REPS = 3


def rank_bytes(dg, prob, rank: int = 0) -> dict:
    """Bytes rank ``rank`` stages, by leaf (``L<level>/<name>``, ``a0``,
    ``b``): its ``rank_args`` on the host, its fine payload slab and its
    right-hand-side slab."""
    args = dg.rank_args(rank, "cpu")
    out = {f"L{i}/{k}": _nbytes(v) for i, lv in enumerate(args["levels"])
           for k, v in sorted(lv.items())}
    out["a0"] = _nbytes(dg.scatter_fine_payloads(prob.A.data, rank))
    out["b"] = _nbytes(dg.scatter_vector(prob.b, rank))
    return out


def staging_row(prob, setupd, ndev: int, m: int) -> dict:
    """One production-mesh row: ``setupd`` staged for ``ndev`` ranks."""
    from repro_torch.dist.solver import build_dist_gamg
    from repro_torch.obs.model import dist_cycle_comm
    t0 = time.perf_counter()
    dg = build_dist_gamg(setupd, ndev)
    stage_s = time.perf_counter() - t0
    by_leaf = rank_bytes(dg, prob)
    comm = dist_cycle_comm(dg)
    return {
        "status": "OK", "kind": "amg_solve",
        "mesh": [ndev], "n_devices": ndev,
        "stage_s": round(stage_s, 2),
        "grid": f"{m}^3 Q1 elasticity "
                f"({prob.A.shape[0]} unknowns, "
                f"{len(setupd.levels) + 1} levels)",
        "halo_strategy": dg.levels[0].a_op.halo.strategy,
        "placement": dg.placement,
        "memory": {"argument_bytes": sum(by_leaf.values()),
                   "argument_bytes_by_leaf": by_leaf},
        "collectives": {
            "source": "comm model (obs.model.dist_cycle_comm), one V-cycle "
                      "a rank",
            "msgs": sum(r["msgs"] for r in comm),
            "total_bytes": sum(r["halo_bytes"] + r["gather_bytes"]
                               for r in comm),
            "levels": comm},
    }


def card_row(prob, setupd, device) -> dict:
    """The hot path on one rank: ``make_dist_solver`` at world size 1
    (NCCL on a card, gloo on the CPU) against the single-device solve."""
    import torch.distributed as tdist

    from repro_torch.core import gamg
    from repro_torch.core.spmv import spmv_bcsr_ref
    from repro_torch.dist.comm import RankComm
    from repro_torch.dist.solver import build_dist_gamg, make_dist_solver
    dev = resolve_device(device)
    single = gamg.hier_solve(setupd, gamg.recompute(setupd, prob.A.data),
                             prob.b, rtol=RTOL, maxiter=MAXITER)
    x_ref = single.x
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_amg_") as tmp:
        tdist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=600))
        try:
            dg = build_dist_gamg(setupd, 1)
            args = dg.rank_args(0, dev)
            a0 = dg.scatter_fine_payloads(prob.A.data, 0)
            b = dg.scatter_vector(prob.b, 0)
            run = make_dist_solver(dg, setupd, RankComm(), rtol=RTOL,
                                   maxiter=MAXITER)
            ms = []
            for i in range(CARD_REPS + 1):
                sync(dev)
                t0 = time.perf_counter()
                x, iters, relres, ok, status = run(args, a0, b)
                sync(dev)
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
            x = dg.gather_vector(x[None])
        finally:
            tdist.destroy_process_group()
    peak = (torch.cuda.max_memory_allocated(dev) - held
            if dev.type == "cuda" else None)
    diff = float((x - x_ref).abs().max() / x_ref.abs().max())
    a_cpu = dataclasses.replace(prob.A, data=prob.A.data.cpu())
    b_cpu = prob.b.cpu()
    true_relres = float(torch.linalg.vector_norm(
        b_cpu - spmv_bcsr_ref(a_cpu, x.cpu()))
        / torch.linalg.vector_norm(b_cpu))
    return {
        "status": "OK", "kind": "amg_solve", "mesh": [1], "n_devices": 1,
        "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_line() if dev.type == "cuda" else None,
        "iters": int(iters), "single_device_iters": int(single.iters),
        "relres": float(relres), "true_relres": true_relres,
        "converged": bool(ok), "x_rel_diff": diff,
        "measured": {"ms": statistics.median(ms), "ms_all": ms},
        "memory": {"peak_measured_bytes": peak},
        "placement": dg.placement,
    }


def run_amg_dryrun(force: bool = False, m: int = 21, device="cuda") -> int:
    """The ``single`` (256 ranks), ``multi`` (512) and ``card`` rows of
    ``amg-elasticity-q1-m{m}|solve|<mesh>|base``, appended to the results
    file; returns 1 if a row failed."""
    from repro_torch.core import gamg
    from repro_torch.fem.assemble import assemble_elasticity
    dev = resolve_device(device)
    results = _load_results()
    t0 = time.perf_counter()
    prob = assemble_elasticity(m, device=dev)
    setupd = gamg.setup(prob.A, prob.B, coarse_size=60)
    print(f"[setup]  m={m} levels {setupd.stats['level_rows']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    failures = 0
    rows = [(mesh_name, ndev) for mesh_name, ndev in RANKS] + [("card", 1)]
    for mesh_name, ndev in rows:
        key = f"amg-elasticity-q1-m{m}|solve|{mesh_name}|base"
        if key in results and not force and \
                results[key].get("status") == "OK":
            print(f"[cached] {key}")
            continue
        print(f"[run]    {key} (ndev={ndev}) ...", flush=True)
        try:
            rec = (card_row(prob, setupd, dev) if mesh_name == "card"
                   else staging_row(prob, setupd, ndev, m))
            _save_results({key: rec})
            if mesh_name == "card":
                print(f"         OK iters={rec['iters']} (single-device "
                      f"{rec['single_device_iters']}) x_rel_diff="
                      f"{rec['x_rel_diff']:.3e} true_relres="
                      f"{rec['true_relres']:.3e} ms={rec['measured']['ms']:.3f}"
                      f" card={rec['card']}", flush=True)
            else:
                print(f"         OK stage={rec['stage_s']}s "
                      f"args/rank={rec['memory']['argument_bytes']/2**20:.2f}"
                      f"MiB halo={rec['halo_strategy']} "
                      f"msgs/cycle={rec['collectives']['msgs']} "
                      f"placement={rec['placement']}", flush=True)
        except Exception as e:
            _save_results({key: {"status": "FAIL", "error": repr(e),
                                 "trace": traceback.format_exc()[-2000:]}})
            failures += 1
            print(f"         FAIL {e!r}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(run_amg_dryrun())
