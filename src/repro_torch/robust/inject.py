"""Deterministic, schedule-driven fault injection (torch twin of
``repro.robust.inject``): the health flags and the recovery ladder need
failures on demand, so this module plants NaN/Inf values or bit flips at
fixed sites of the solver stack.

Sites (each hot loop calls ``maybe(site, x, ...)`` at these points):

=============  ============================================================
``"spmv"``     operator-apply output in ``pcg`` / ``block_pcg``
               (step-gated: fires at CG iteration ``step``)
``"precond"``  preconditioner (V-cycle) output in the same loops
               (step-gated)
``"vcycle"``   restricted residual inside the V-cycle (level-gated)
``"coarse"``   coarse-level direct-solve output inside the V-cycle
``"hierarchy"``level operator payloads inside ``gamg.recompute``
               (level-gated; the coarsest payload is level
               ``n_levels - 1``)
``"halo"``     the assembled halo window of a distributed apply
               (``repro_torch.dist.pamg.finish_halo_exchange``: every
               ppermute or all-gather window; local and replicated
               operands move no bytes and are exempt)
=============  ============================================================

No schedule installed: ``maybe(site, x) is x`` — no launch, no copy, no
sync.  The step and level gates are compared on the host ints the port's
loops already carry (the CG iteration counter, the level index), so a
fault whose gate does not match costs nothing either.  A firing fault
corrupts a copy of ``x``; the input is never written.

Determinism: a fault is a pure function of (site, step / level, index) —
no RNG, no clock — so a faulted run is exactly reproducible.

Trace-time binding.  The reference bakes a schedule into its jitted
programs at trace time: programs traced before ``install`` stay clean, a
recovery retry is clean of transient faults because its fresh traces are
made under ``suppress_transient()``, and the retried closures stay clean
(and on the rung's knobs) at every later call.  The port runs eagerly, so
``maybe`` reads the installed schedule at each call; the hot closures the
reference jits (``gamg.make_recompute``, ``gamg.make_solve``,
``gamg.make_coeff_recompute``, ``gamg.make_coeff_solve``,
``multirhs.block_krylov.make_block_solve``) are wrapped in ``traced``,
which binds the schedule, the knobs the closure names and the
observability mode (``repro_torch.obs.trace``) at the first call with
each argument signature, as a trace does.  A bare ``maybe``
outside those closures (``gamg.recompute`` called directly, say) sees the
schedule installed at that call, as the reference's un-jitted code does.

``REPRO_TORCH_FAULTS`` (read once, at import, through
``kernels.backend.resolve_faults``; the reference's ``REPRO_FAULTS`` is
never read): semicolon-separated specs
``site:kind[@step][:level=N][:index=N][:persistent]``, e.g.
``REPRO_TORCH_FAULTS="precond:nan@3;vcycle:bitflip:level=1"``.  Faults are
transient unless marked ``:persistent``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.obs import trace as obs_trace

KINDS = ("nan", "inf", "bitflip")
SITES = ("spmv", "precond", "vcycle", "coarse", "hierarchy", "halo")

#: the integer view of each float width, for the bit flip
_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One deterministic corruption.

    ``step`` / ``level`` gate step- and level-aware sites; a gate of
    ``None`` (or a site that carries no counter) fires unconditionally.
    ``index`` is the flat element corrupted (modulo the size, so any index
    is valid for any site).
    """

    site: str
    kind: str
    step: Optional[int] = None
    level: Optional[int] = None
    index: int = 0
    transient: bool = True

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"invalid fault site {self.site!r}: "
                             f"expected one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"invalid fault kind {self.kind!r}: "
                             f"expected one of {KINDS}")

    def corrupt(self, x: torch.Tensor, step=None) -> torch.Tensor:
        """A corrupted copy of ``x``, or ``x`` itself when the step gate
        (a host int on both sides) does not match."""
        if self.step is not None and step is not None and step != self.step:
            return x
        flat = x.reshape(-1).clone()
        idx = self.index % flat.numel()
        if self.kind == "bitflip":
            # flip the exponent's top bit (62, 30 or 14): a small value
            # becomes a huge one, the classic rendering of a flipped bit
            ints = flat.view(_INT[flat.element_size()])
            ints[idx] ^= 1 << (8 * flat.element_size() - 2)
        else:
            flat[idx] = float("nan") if self.kind == "nan" \
                else float("inf")
        return flat.reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered set of faults; applied wherever site and level match."""

    faults: Tuple[Fault, ...]

    def apply(self, site: str, x: torch.Tensor, step=None,
              level=None) -> torch.Tensor:
        for f in self.faults:
            if f.site != site:
                continue
            if f.level is not None and level is not None \
                    and f.level != level:
                continue
            x = f.corrupt(x, step)
        return x

    def without_transient(self) -> Optional["FaultSchedule"]:
        keep = tuple(f for f in self.faults if not f.transient)
        return FaultSchedule(keep) if keep else None


def parse_schedule(spec: str) -> FaultSchedule:
    """Parse the ``REPRO_TORCH_FAULTS`` mini-language (module docstring);
    the reference's grammar."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"invalid fault spec {part!r}: expected "
                f"site:kind[@step][:level=N][:index=N][:persistent]")
        site = fields[0].strip()
        kind = fields[1].strip()
        step = None
        if "@" in kind:
            kind, step_s = kind.split("@", 1)
            step = int(step_s)
        kw = dict(site=site, kind=kind, step=step)
        for opt in fields[2:]:
            opt = opt.strip()
            if opt == "persistent":
                kw["transient"] = False
            elif "=" in opt:
                key, val = opt.split("=", 1)
                if key not in ("level", "index"):
                    raise ValueError(f"invalid fault option {opt!r} in "
                                     f"{part!r}")
                kw[key] = int(val)
            else:
                raise ValueError(f"invalid fault option {opt!r} in {part!r}")
        faults.append(Fault(**kw))
    if not faults:
        raise ValueError(f"empty fault spec {spec!r}")
    return FaultSchedule(tuple(faults))


# ---------------------------------------------------------------------------
# The (single, module-global) active schedule
# ---------------------------------------------------------------------------

_SCHEDULE: Optional[FaultSchedule] = None


def install(schedule: Optional[FaultSchedule]) -> None:
    """Activate a schedule; it takes effect at the next call of any site."""
    global _SCHEDULE
    if schedule is not None and not isinstance(schedule, FaultSchedule):
        raise ValueError(f"expected a FaultSchedule or None, got "
                         f"{schedule!r}")
    _SCHEDULE = schedule


def clear() -> None:
    install(None)


def current() -> Optional[FaultSchedule]:
    return _SCHEDULE


@contextlib.contextmanager
def active(schedule: Optional[FaultSchedule]):
    """Scoped installation (always restores the previous schedule);
    ``None`` runs the scope with no schedule."""
    prev = _SCHEDULE
    install(schedule)
    try:
        yield schedule
    finally:
        install(prev)


@contextlib.contextmanager
def suppress_transient():
    """Scoped transient-fault suppression: the recovery ladder's retries
    run under this (persistent faults stay live)."""
    prev = _SCHEDULE
    if prev is not None:
        install(prev.without_transient())
    try:
        yield
    finally:
        install(prev)


def maybe(site: str, x: torch.Tensor, *, step=None,
          level=None) -> torch.Tensor:
    """The hook the hot loops call: ``x`` itself unless a schedule is
    installed."""
    if _SCHEDULE is None:
        return x
    return _SCHEDULE.apply(site, x, step=step, level=level)


def _signature(args) -> tuple:
    """What a jit cache keys a call on: each tensor's shape, dtype and
    device, and the type of every other argument (``None`` included)."""
    return tuple((tuple(a.shape), a.dtype, a.device)
                 if isinstance(a, torch.Tensor) else type(a) for a in args)


def traced(fn: Callable, knobs: Callable[[], dict] = dict,
           obs: Optional[str] = None) -> Callable:
    """``fn`` with the reference's trace-time binding: the schedule
    installed at the first call with each argument signature, the keyword
    arguments ``knobs()`` returns then, and the observability mode then in
    force (``obs``, when given, instead: a closure that resolved it at
    build time) are what every later call with that signature runs under,
    as a jitted program keeps what it was traced with (module
    docstring)."""
    bound = {}

    def call(*args):
        key = _signature(args)
        if key not in bound:
            bound[key] = (_SCHEDULE, knobs(), obs_trace.resolve(obs))
        schedule, kw, mode = bound[key]
        with active(schedule), obs_trace.use(mode):
            return fn(*args, **kw)

    return call


def _arm_from_env() -> None:
    """A set ``REPRO_TORCH_FAULTS`` arms the schedule for the whole
    process."""
    from repro_torch.kernels import backend
    install(backend.resolve_faults())


_arm_from_env()
