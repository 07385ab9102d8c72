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
"""
from __future__ import annotations

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
    "recompute": {...}}``, each keyed by ``KEYS``; the cycle entry is the
    recompute-differenced count.  The counters of ``comm`` are reset.
    """
    comm.reset()
    ds._rank_recompute(dg, args, a0, comm, overlap)
    rec = comm.counts()
    comm.reset()
    states, chol = ds._rank_recompute(dg, args, a0, comm, overlap)
    ds._rank_vcycle(dg, args, states, chol, b, comm, overlap)
    full = comm.counts()
    comm.reset()
    return {"cycle": {k: full[k] - rec[k] for k in KEYS},
            "recompute": {k: rec[k] for k in KEYS}}


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
