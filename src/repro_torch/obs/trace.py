"""Solver tracing: named profiler ranges and the device solve counters
(torch twin of ``repro.obs.trace``).

Two opt-in mechanisms, gated by one knob (``REPRO_TORCH_OBS``, resolved by
``repro_torch.kernels.backend.resolve_obs``):

``"spans"``     every kernel family (``kernels/block_spmv``, ...), every
                V-cycle stage (``vcycle/level{i}/smooth|restrict|prolong``,
                ``vcycle/coarse``) and every recompute stage
                (``recompute/level{i}/smoother_data|ptap``,
                ``recompute/coarse_chol``) runs inside a
                ``torch.profiler.record_function`` range, so a
                ``torch.profiler`` capture reads as a per-level timeline.
                A range dispatches no op: the solution is bitwise the
                unobserved one.

``"counters"``  spans plus a ``CycleTally`` of device tensors threaded
                through ``pcg`` / ``block_pcg`` / ``vcycle``: per-level
                visits, smoother applications, coarse solves,
                operator and preconditioner applications, and the modeled
                HBM bytes of the cycles (``repro_torch.obs.model
                .vcycle_traffic``).  Each count is a small torch kernel on
                the device; none waits on the host.

``"off"``       (default) ``span`` returns a bare ``nullcontext`` and no
                tally is threaded: a solve dispatches the aten ops of an
                unobserved one, in the same order.

Binding.  The reference reads the mode at trace time, so a program traced
while the mode was off stays clean after the mode changes.  The port runs
eagerly: ``make_solve(obs=)`` and ``make_block_solve(obs=)`` resolve the
mode when the closure is built, and the other hot closures bind the mode
in force at their first call per argument signature
(``repro_torch.robust.inject.traced``); each call then runs under its
bound mode (``use``).  A bare ``span`` outside those closures reads the
mode at that call, as the reference's un-jitted code does.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, NamedTuple, Optional

import torch

MODES = ("off", "spans", "counters")

#: explicit override (``use``); ``None`` defers to ``REPRO_TORCH_OBS``
_MODE: Optional[str] = None


def resolve(mode: Optional[str] = None) -> str:
    """The mode in force: the explicit argument, else the ``use`` scope,
    else the environment."""
    from repro_torch.kernels import backend
    if mode is not None:
        return backend.resolve_obs(mode)
    if _MODE is not None:
        return _MODE
    return backend.resolve_obs()


def spans_enabled(mode: Optional[str] = None) -> bool:
    return resolve(mode) in ("spans", "counters")


def counters_enabled(mode: Optional[str] = None) -> bool:
    return resolve(mode) == "counters"


@contextlib.contextmanager
def use(mode: str):
    """Scoped mode override; it takes precedence over the environment."""
    from repro_torch.kernels import backend
    global _MODE
    prev = _MODE
    _MODE = backend.resolve_obs(mode)
    try:
        yield
    finally:
        _MODE = prev


def span(name: str, mode: Optional[str] = None):
    """A ``record_function`` range around one solver stage, or a bare
    ``nullcontext`` when spans are off (no profiler call at all)."""
    if not spans_enabled(mode):
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def spanned(name: str) -> Callable:
    """Decorator: run the function inside ``span(name)`` (the kernel
    wrappers' family ranges)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# The device counter carry
# ---------------------------------------------------------------------------

class CycleTally(NamedTuple):
    """Device solve counters threaded through the Krylov loops: int32
    counts and an f64 ``modeled_bytes``; per-level tensors are indexed by
    hierarchy level (0 = finest).  Reading one costs a transfer after the
    solve, never a sync inside it."""

    level_visits: torch.Tensor      # (n_levels - 1,) down-leg visits
    smoother_applies: torch.Tensor  # (n_levels - 1,) pre + post smooths
    coarse_solves: torch.Tensor     # () direct coarse solves
    operator_applies: torch.Tensor  # () fine-operator applications
    precond_applies: torch.Tensor   # () V-cycle invocations
    modeled_bytes: torch.Tensor     # () modeled HBM bytes (f64)


def zero_tally(n_levels: int, device="cuda") -> CycleTally:
    """A fresh all-zero tally on ``device`` (CUDA unless the caller asks
    for the CPU) for an ``n_levels``-deep hierarchy (the count includes
    the coarse level; the per-level tensors cover the smoothed ones).
    Every tensor is filled on the device."""
    from repro_torch.kernels.backend import resolve_device
    device = resolve_device(device)
    nl = max(int(n_levels) - 1, 0)

    def z(shape=(), dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CycleTally(level_visits=z((nl,)), smoother_applies=z((nl,)),
                      coarse_solves=z(), operator_applies=z(),
                      precond_applies=z(),
                      modeled_bytes=z(dtype=torch.float64))


def bump(counts: torch.Tensor, level: int) -> torch.Tensor:
    """``counts`` with one added at ``level`` (a new tensor, as the
    reference's ``.at[level].add(1)``)."""
    out = counts.clone()
    out[level] += 1
    return out


def attach_model_bytes(tally: CycleTally, cycle_bytes: float) -> CycleTally:
    """``modeled_bytes`` = preconditioner applications x the modeled bytes
    of one cycle (``obs.model.vcycle_traffic(...)["total"]``)."""
    total = tally.precond_applies.to(tally.modeled_bytes.dtype) \
        * cycle_bytes
    return tally._replace(modeled_bytes=total)


def describe_tally(tally: CycleTally) -> str:
    """One human line (reads the tally on the host)."""
    lv = tally.level_visits.cpu().tolist()
    sm = tally.smoother_applies.cpu().tolist()
    return (f"precond={int(tally.precond_applies)} "
            f"op={int(tally.operator_applies)} "
            f"coarse={int(tally.coarse_solves)} "
            f"level_visits={lv} smoother={sm} "
            f"modeled_MB={float(tally.modeled_bytes) / 1e6:.2f}")


# ---------------------------------------------------------------------------
# Host-side spans for the distributed path
# ---------------------------------------------------------------------------

def process_rank() -> int:
    """This process's rank in the default ``torch.distributed`` group; 0
    when there is no process group."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


@contextlib.contextmanager
def rank0_span(name: str, registry=None):
    """Host-side timing span recorded only on process rank 0 (or with no
    process group) and only when spans are on.

    It wraps a dist entry point's call site; every other rank runs the
    same code with the recording skipped, so no rank does host work the
    others do not.  Yields a ``stop(out)`` callable: the clock stops after
    the CUDA work of ``out`` has finished, and the wall seconds land in
    the registry's ``{name}/seconds`` histogram (the default registry
    unless ``registry`` is given).
    """
    emit = process_rank() == 0 and spans_enabled()
    state = {"out": None}

    def stop(out):
        state["out"] = out
        return out

    t0 = time.perf_counter()
    try:
        yield stop
    finally:
        if emit:
            from repro_torch.obs.metrics import block_ready, \
                default_registry
            if state["out"] is not None:
                block_ready(state["out"])
            dt = time.perf_counter() - t0
            reg = registry if registry is not None else default_registry()
            reg.histogram(f"{name}/seconds",
                          help="rank-0 host span").observe(dt)


def wrap_threaded_precond(apply_m: Callable, precond_dtype,
                          outer_dtype) -> Callable:
    """The tally-threaded twin of ``core.krylov.wrap_precond``:
    ``apply_m(r, tally) -> (z, tally)`` with the same mixed-precision
    casts around it (``apply_m`` itself when none is needed)."""
    if precond_dtype is None or precond_dtype == outer_dtype:
        return apply_m

    def wrapped(r, tally):
        z, tally = apply_m(r.to(precond_dtype), tally)
        return z.to(outer_dtype), tally

    return wrapped
