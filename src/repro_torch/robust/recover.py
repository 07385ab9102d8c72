"""Policy-driven breakdown recovery — the escalation ladder (torch twin of
``repro.robust.recover``).

When a monitored solve comes back flagged (``SolveHealth.status != 0``),
``RobustSolver`` walks these rungs in order, bounded by
``RecoveryPolicy.max_attempts``:

``"recompute"``
    transient fault, or a corrupted or stale hierarchy: fresh closures
    and the hierarchy recomputed from the stored fine values.
``"re-setup"``
    corrupted symbolic state: the whole cold ``gamg.setup`` again from
    the stored operator, and everything above it.
``"f64-rebuild"``
    reduced-precision breakdown (an f32 or bf16 hierarchy whose V-cycle
    went indefinite, or whose coarse factor is NaN): re-setup under
    ``PrecisionPolicy.double()``.  Offered only when the setup is not
    already f64.
``"reference-path"``
    a suspected kernel fault: re-setup with the Galerkin products off the
    fused kernel.  The reference sets its plain ``reference`` paths here
    (``REPRO_SPGEMM_PATH`` / ``REPRO_SPMM_PATH``).  The port runs no plain
    version on the card, so on a CUDA setup the rung sets
    ``REPRO_TORCH_SPGEMM_PATH=pairs`` — the unfused ``block_pair_gemm`` +
    ``block_seg_sum`` kernels — and on the CPU ``reference``.  The port
    has no SpMM path knob.  The rung keeps its name, so ``attempts``
    compare equal to the reference's.

Every rung rebuilds its closures under ``inject.suppress_transient()``
and the rung's knobs.  The reference's fresh traces keep both, and so do
the port's closures (``inject.traced`` binds the schedule and the SpGEMM
path at their first call): after a recovery, later ``solve`` and
``update_operator`` calls stay clean of transient faults, and after the
reference-path rung they stay on its Galerkin path.

A recovered solve reports ``"recovered"``; an exhausted ladder reports
``"degraded"`` when the best iterate made progress (finite ``best_relres
< 1`` and a finite ``x``: the minimum-residual iterate is returned) and
``"failed"`` otherwise (``x`` zeroed: an explicit failure must never look
like an answer).

``REPRO_TORCH_RECOVER`` (``kernels.backend.resolve_recover``): ``off``
disables the ladder, ``on`` enables the defaults, an integer sets
``max_attempts``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gamg
from repro_torch.core.krylov import CGResult
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.robust import inject
from repro_torch.robust.health import HEALTHY, STATUS_NAMES, hierarchy_finite


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Which rungs the ladder may climb, and how many in total."""

    max_attempts: int = 3
    allow_recompute: bool = True
    allow_resetup: bool = True
    allow_f64_rebuild: bool = True
    allow_reference_path: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")


@dataclasses.dataclass
class RecoverOutcome:
    """One ladder-mediated solve.

    ``status``: ``"ok"`` (healthy first try), ``"recovered"`` (a rung
    fixed it), ``"degraded"`` (exhausted, best iterate returned) or
    ``"failed"`` (exhausted, no usable iterate: ``result.x`` is zeroed).
    ``attempts`` lists the rung names tried, in order.
    """

    status: str
    result: CGResult
    attempts: Tuple[str, ...] = ()

    @property
    def x(self):
        return self.result.x


@contextlib.contextmanager
def _env_scope(overrides: dict):
    """Scoped ``os.environ`` overrides (the backend resolvers re-read the
    environment at every call, so the scope covers a rung's rebuild)."""
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_path_env(device) -> dict:
    """The "reference-path" rung's knobs on ``device``: the unfused
    ``pairs`` Galerkin kernels on CUDA, the plain ``reference`` path on
    the CPU."""
    path = "pairs" if torch.device(device).type == "cuda" else "reference"
    return {"REPRO_TORCH_SPGEMM_PATH": path}


class RobustSolver:
    """``GAMGSolver`` with health-gated solves and the recovery ladder.

    Same front door (setup once, ``update_operator`` hot, ``solve`` many),
    but ``solve`` returns a ``RecoverOutcome`` whose ``result`` is the
    ``CGResult``.  The healthy path is one monitored solve on the cached
    closures; the ladder only wakes on a flagged result.  Runs on the
    device of ``A.data``.
    """

    def __init__(self, A, B, *, recovery: Optional[RecoveryPolicy] = None,
                 rtol: float = 1e-8, maxiter: int = 200, **setup_opts):
        from repro_torch.kernels.backend import resolve_recover
        self._A = A
        self._B = B
        self.recovery = resolve_recover(recovery) or RecoveryPolicy()
        self._rtol = rtol
        self._maxiter = maxiter
        self._setup_opts = dict(setup_opts)
        self._a_fine_data = A.data
        self.n_recoveries = 0
        self.last_attempts: Tuple[str, ...] = ()
        self._stage(self._setup_opts)

    # ---- staging (everything a rung may need to rebuild) ----------------
    def _stage(self, setup_opts: dict) -> None:
        """Cold setup + fresh closures + hierarchy recompute."""
        self.setupd = gamg.setup(self._A.with_data(self._a_fine_data),
                                 self._B, **setup_opts)
        self._refresh()

    def _refresh(self) -> None:
        """Fresh closures + hierarchy from the existing setup."""
        self._recompute = gamg.make_recompute(self.setupd)
        self._solve = gamg.make_solve(self.setupd, rtol=self._rtol,
                                      maxiter=self._maxiter)
        self.hierarchy = self._recompute(self._a_fine_data)

    # ---- operator lifecycle ---------------------------------------------
    def update_operator(self, a_fine_data) -> None:
        self._a_fine_data = a_fine_data
        self.hierarchy = self._recompute(self._a_fine_data)

    # ---- the ladder ------------------------------------------------------
    def _rungs(self):
        pol = self.recovery
        rungs = []
        if pol.allow_recompute:
            rungs.append(("recompute", {}, self._refresh))
        if pol.allow_resetup:
            rungs.append(("re-setup", {},
                          lambda: self._stage(self._setup_opts)))
        if pol.allow_f64_rebuild and \
                self.setupd.precision != PrecisionPolicy.double():
            opts = dict(self._setup_opts, precision="f64")
            rungs.append(("f64-rebuild", {}, lambda: self._stage(opts)))
        if pol.allow_reference_path:
            rungs.append(("reference-path",
                          reference_path_env(self._a_fine_data.device),
                          lambda: self._stage(self._setup_opts)))
        return rungs[:pol.max_attempts]

    def solve(self, b) -> RecoverOutcome:
        res = self._solve(self.hierarchy, b)
        if int(res.health.status) == HEALTHY:
            self.last_attempts = ()
            return RecoverOutcome("ok", res)
        attempts = []
        best = res
        for name, env, rebuild in self._rungs():
            attempts.append(name)
            # transient faults are gone from the retry, persistent ones
            # stay
            with _env_scope(env), inject.suppress_transient():
                rebuild()
                res = self._solve(self.hierarchy, b)
            if int(res.health.status) == HEALTHY:
                self.n_recoveries += 1
                self.last_attempts = tuple(attempts)
                return RecoverOutcome("recovered", res, tuple(attempts))
            if self._better(res, best):
                best = res
        self.last_attempts = tuple(attempts)
        best_rel = float(best.health.best_relres)
        if np.isfinite(best_rel) and best_rel < 1.0 \
                and bool(torch.isfinite(best.x).all()):
            return RecoverOutcome("degraded", best, tuple(attempts))
        # an explicit failure must never look like an answer
        zero = best._replace(x=torch.zeros_like(best.x))
        return RecoverOutcome("failed", zero, tuple(attempts))

    @staticmethod
    def _better(a: CGResult, b: CGResult) -> bool:
        ra = float(a.health.best_relres)
        rb = float(b.health.best_relres)
        if not np.isfinite(ra):
            return False
        return (not np.isfinite(rb)) or ra < rb

    # ---- diagnostics ----------------------------------------------------
    def hierarchy_ok(self) -> bool:
        """Host bool: no NaN/Inf anywhere in the cached hierarchy."""
        return bool(hierarchy_finite(self.hierarchy))

    def describe_last(self) -> str:
        return " -> ".join(self.last_attempts) if self.last_attempts \
            else "(no recovery needed)"


def ladder_solve(A, B, b, *, recovery: Optional[RecoveryPolicy] = None,
                 rtol: float = 1e-8, maxiter: int = 200,
                 **setup_opts) -> RecoverOutcome:
    """One-shot convenience: setup + monitored solve + ladder on ``b``."""
    solver = RobustSolver(A, B, recovery=recovery, rtol=rtol,
                          maxiter=maxiter, **setup_opts)
    return solver.solve(b)


__all__ = ["RecoveryPolicy", "RecoverOutcome", "RobustSolver",
           "ladder_solve", "STATUS_NAMES"]
