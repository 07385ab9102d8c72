"""Device-side hierarchy-staleness monitor: the re-coarsening policy
(torch twin of ``repro.sim.staleness``).

The reuse model (PETSc ``-pc_gamg_reuse_interpolation``) freezes
aggregates and prolongator values at setup time; ``gamg.recompute`` only
refreshes operators and smoother data.  As the coefficients walk away
from the setup-time field, the frozen prolongator's interpolation quality
(and so the CG iteration count) decays.  This monitor decides when a
rebuild is due, from quantities the march already holds, on the device:

* **iteration drift** — the reference count is the minimum over the first
  ``ref_window`` steps after a rebuild; later, a step needing more than
  ``ref_iters + iter_drift`` iterations trips;
* **coefficient drift** — ``||E - E_ref|| / max(||E_ref||, tiny)`` above
  ``coeff_rtol`` trips even before the iterations degrade.

``staleness_update`` runs once per march step and copies nothing between
host and device; the segment loop reads ``tripped`` (``repro_torch.sim
.driver``), and a rebuild resets the monitor with ``staleness_init``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: "reference not yet established" iteration count: the int32 maximum
_REF_UNSET = torch.iinfo(torch.int32).max


class StalenessConfig(NamedTuple):
    """Policy knobs."""

    iter_drift: int = 4      # iterations above the reference that trip
    ref_window: int = 3      # steps that establish the reference count
    coeff_rtol: float = 0.4  # relative ||E - E_ref|| that trips


class StalenessState(NamedTuple):
    """Per-march monitor state (device tensors riding the march carry)."""

    e_ref: torch.Tensor        # (ne,) coefficient snapshot at the rebuild
    ref_iters: torch.Tensor    # int32 reference count (min over the window)
    steps_since: torch.Tensor  # int32 steps since the last rebuild
    tripped: torch.Tensor      # bool: a segment boundary is due
    coeff_drift: torch.Tensor  # last relative coefficient drift
    iter_excess: torch.Tensor  # int32 last iters - reference


def staleness_init(e_ref: torch.Tensor) -> StalenessState:
    """Fresh monitor state for a hierarchy just built against ``e_ref``
    (every scalar filled on ``e_ref``'s device)."""
    dev = e_ref.device

    def fill(value, dtype):
        return torch.full((), value, dtype=dtype, device=dev)

    return StalenessState(
        e_ref=e_ref, ref_iters=fill(_REF_UNSET, torch.int32),
        steps_since=fill(0, torch.int32), tripped=fill(False, torch.bool),
        coeff_drift=fill(0.0, e_ref.dtype),
        iter_excess=fill(0, torch.int32))


def staleness_update(state: StalenessState, iters: torch.Tensor,
                     E: torch.Tensor, cfg: StalenessConfig
                     ) -> StalenessState:
    """One monitor step after a successful solve.

    ``iters`` is the step's CG iteration count as a device int32 scalar,
    ``E`` the per-element coefficient field the step solved with.  Inside
    the reference window the count only establishes the reference (the
    minimum), so the first post-rebuild steps, whose warm starts are still
    settling, cannot trip the drift criterion themselves."""
    iters = iters.to(torch.int32)
    in_window = state.steps_since < cfg.ref_window
    ref = torch.where(in_window, torch.minimum(state.ref_iters, iters),
                      state.ref_iters)
    # an unset reference (ref_window=0) never reports an excess
    excess = iters - torch.where(ref == _REF_UNSET, iters, ref)
    iter_trip = ~in_window & (excess > cfg.iter_drift)
    diff = torch.linalg.vector_norm(E - state.e_ref)
    base = torch.clamp_min(torch.linalg.vector_norm(state.e_ref),
                           torch.finfo(state.e_ref.dtype).tiny)
    drift = diff / base
    coeff_trip = drift > cfg.coeff_rtol
    return StalenessState(
        e_ref=state.e_ref, ref_iters=ref,
        steps_since=state.steps_since + 1,
        tripped=iter_trip | coeff_trip,
        coeff_drift=drift.to(state.coeff_drift.dtype),
        iter_excess=excess.to(torch.int32))
