"""Measured messages of the distributed V-cycle (torch twin of
``repro.dist.measure``).

``repro_torch.obs.model.dist_cycle_comm`` *predicts* the per-cycle
message traffic of the distributed hierarchy; this module *measures* it.
The reference counts the collective equations of a traced ``shard_map``
program; here the rank's ``RankComm`` counts the messages it issues (one
per ppermute slab, ``world - 1`` per all-gather, with their bytes), so the
count is of real calls.  The V-cycle is isolated by differencing: one run
of the rank recompute alone, one of the recompute and one V-cycle; the
recompute's messages (the power iterations' halos, the stage-2 windows,
the coarse gather) cancel.  The counts do not depend on the halo
schedule: the overlapped apply reorders the same exchanges.

CLI (``python -m repro_torch.dist.measure [m] [pr] [pc] [--device cpu]``,
the twin of ``python -m repro.dist.measure m pr pc``): assembles the
``m^3`` problem (device assembly), sets GAMG up as the reference does
(the MIS coarsener, ``coarse_size=30``, f64), stages it on a ``(pr,
pc)`` ``ProcessMesh`` and counts one V-cycle on the ``pr`` ranks that
mesh runs (the slabs follow its row axis).  The ranks are processes
spawned with a ``file://`` rendezvous, as the selftest's: NCCL for one
rank on the card, gloo for more ranks (which share the card) or on the
CPU.  Rank 0 prints one JSON line with the reference's keys (``m``,
``pr``, ``pc``, ``measured``, ``model_msgs``, ``model_rows``) plus
``model_bytes``, ``agree`` and the kernel launches by family summed over
the ranks.  ``agree`` holds the messages to the model always and the
bytes only at ``pc == 1``: at ``pc > 1`` the model splits a slab's halo
bytes ``pc`` ways, while a rank's ``RankComm`` counts whole slabs.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile

from repro_torch.dist import solver as ds

#: the counters kept (``RankComm.counts`` keys); the comparison reads
#: ``msgs`` and ``bytes``, ``staged_bytes`` is the host staging of a
#: gloo rank on the card (0 elsewhere)
KEYS = ("ppermute", "all_gather", "msgs", "bytes", "staged_bytes")


def measured_cycle_comm(dg, args: dict, a0, b, comm,
                        overlap: bool = True) -> dict:
    """Per-cycle message counts of ``dg``'s V-cycle on this rank.

    ``args``, ``a0`` and ``b`` are the rank's operands as
    ``make_dist_solver`` takes them.  Every rank of ``comm`` calls this
    together (it runs the collectives).  Returns ``{"cycle": {...},
    "recompute": {...}, "recompute_calls": {...}}``, each keyed by
    ``KEYS``: the cycle entry is the recompute-differenced count,
    ``recompute_calls`` every message a recompute issues, and
    ``recompute`` the count the reference reports, whose traced power
    iteration holds its loop body once: a recompute whose power iteration
    runs once (10 times in ``recompute_calls``).  The counters of
    ``comm`` are reset.
    """
    def counted(fn) -> dict:
        comm.reset()
        fn()
        return comm.counts()

    def cycle():
        states, chol = ds._rank_recompute(dg, args, a0, comm, overlap)
        ds._rank_vcycle(dg, args, states, chol, b, comm, overlap)

    sites = counted(lambda: ds._rank_recompute(dg, args, a0, comm, overlap,
                                               lambda_iters=1))
    rec = counted(lambda: ds._rank_recompute(dg, args, a0, comm, overlap))
    full = counted(cycle)
    comm.reset()
    return {"cycle": {k: full[k] - rec[k] for k in KEYS},
            "recompute": {k: sites[k] for k in KEYS},
            "recompute_calls": {k: rec[k] for k in KEYS}}


def compare(dg, measured: dict, itemsize: int = 8) -> dict:
    """The measured cycle beside the model (``dist_cycle_comm``): the
    reference's report (``model_msgs``, ``model_rows``) plus the model's
    bytes (``halo_bytes + gather_bytes``) and whether both agree."""
    from repro_torch.obs.model import dist_cycle_comm
    rows = dist_cycle_comm(dg, itemsize=itemsize)
    msgs = sum(r["msgs"] for r in rows)
    nbytes = sum(r["halo_bytes"] + r["gather_bytes"] for r in rows)
    cyc = measured["cycle"]
    return {"measured": measured, "model_msgs": msgs, "model_bytes": nbytes,
            "model_rows": rows,
            "agree": cyc["msgs"] == msgs and cyc["bytes"] == nbytes}


def _rank(rank: int, opts, init: str, out_path: str) -> None:
    import torch
    import torch.distributed as tdist

    from repro_torch.core import gamg
    from repro_torch.dist.comm import RankComm
    from repro_torch.dist.partition import ProcessMesh
    from repro_torch.dist.selftest import Launches, _on_all, \
        _setup_digest, _summed
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.kernels import backend

    os.environ["REPRO_TORCH_TUNE"] = "off"      # the ranks launch untuned
    if opts.device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        opts.backend, init_method=init, world_size=opts.pr, rank=rank,
        timeout=datetime.timedelta(seconds=opts.timeout))
    try:
        comm = RankComm()
        prob = assemble_elasticity(opts.m, device=dev)
        setupd = gamg.setup(prob.A, prob.B, coarse_size=30,
                            precision="f64")
        digests = _on_all(comm, _setup_digest(setupd), dev)
        if len(set(digests)) != 1:
            raise AssertionError(f"the ranks built different setups: "
                                 f"{digests}")
        dg = ds.build_dist_gamg(setupd, ProcessMesh((opts.pr, opts.pc)))
        args = dg.rank_args(rank, dev)
        a0 = dg.scatter_fine_payloads(prob.A.data, rank)
        b = dg.scatter_vector(prob.b, rank)
        counted = Launches()
        meas = counted.run(measured_cycle_comm, dg, args, a0, b, comm,
                           backend.resolve_overlap() == "on")
        launches = _summed(comm, counted, dev)
        if rank == 0:
            cmp = compare(dg, meas)
            cyc = meas["cycle"]
            # bytes only on a 1-D mesh (see the module docstring)
            agree = cyc["msgs"] == cmp["model_msgs"] and (
                opts.pc > 1 or cyc["bytes"] == cmp["model_bytes"])
            out = dict(m=opts.m, pr=opts.pr, pc=opts.pc, measured=meas,
                       model_msgs=cmp["model_msgs"],
                       model_rows=cmp["model_rows"],
                       model_bytes=cmp["model_bytes"],
                       agree=agree,
                       levels=setupd.stats["level_rows"],
                       backend=opts.backend, device=str(dev),
                       launches=launches)
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        tdist.destroy_process_group()


def main(m: int = 5, pr: int = 2, pc: int = 1, device="cuda",
         timeout: float = 600.0) -> dict:
    """Count one V-cycle's messages on ``pr`` rank processes; returns rank
    0's report (see the module docstring)."""
    import torch.multiprocessing as mp

    from repro_torch.dist import measure as this
    from repro_torch.kernels import backend
    if pr < 1 or pc < 1:
        raise ValueError(f"pr and pc must be >= 1, got {pr}, {pc}")
    dev = backend.resolve_device(device)
    opts = argparse.Namespace(
        m=m, pr=pr, pc=pc, device=dev.type, timeout=timeout,
        backend="nccl" if dev.type == "cuda" and pr == 1 else "gloo")
    if dev.type == "cuda":
        backend.build_library()      # before any rank can race to build it
    with tempfile.TemporaryDirectory(prefix="repro_measure_") as tmp:
        out_path = os.path.join(tmp, "result.json")
        mp.spawn(this._rank, args=(opts, f"file://{tmp}/rendezvous",
                                   out_path), nprocs=pr, join=True)
        with open(out_path) as f:
            return json.load(f)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.dist.measure",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=5,
                    help="elements per edge of the cube (default 5)")
    ap.add_argument("pr", type=int, nargs="?", default=2,
                    help="mesh rows = rank processes (default 2)")
    ap.add_argument("pc", type=int, nargs="?", default=1,
                    help="mesh columns (default 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.m, args.pr, args.pc, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
