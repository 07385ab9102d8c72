"""Device-resident quasi-static time march with adaptive re-coarsening
(torch twin of ``repro.sim.driver``).

March a material-evolution law (``repro_torch.sim.scenarios``) through
the fused step ``coefficient update -> device assembly -> state-gated
PtAP recompute -> warm-started AMG-PCG``, on the device.  Each step feeds
the previous solution into the law and warm-starts CG from it.

Three modes:

``"frozen"``    one hierarchy for the whole march (``make_scan_march``).
``"adaptive"``  frozen-hierarchy segments (``make_segment``) cut by the
                device staleness monitor (``repro_torch.sim.staleness``);
                at a boundary the host rebuilds aggregates and
                prolongator with ``gamg.setup`` against the current
                field, and the march resumes warm.
``"resetup"``   a full ``gamg.setup`` before every step (segments of one
                step): the accuracy baseline the adaptive march must
                reach with fewer setups.

The reference runs a segment as one ``lax.while_loop`` and the frozen
march as one ``lax.scan``; here both are Python loops over the same
``make_step``.  The records go into device buffers allocated before the
loop, the carry stays on the device, and the segment's exit test
``k < seg_len & step < n_steps & ~tripped & ~blocked`` reads one host
bool per step (the solve itself reads one per CG iteration).  Nothing is
copied from the host inside a segment once its first step has put the
setup's index arrays on the device.

Failure containment: a step whose solve is not ``HEALTHY`` does not
advance the carry (``torch.where`` over the carry's tensors).  In a
segment the step blocks the segment; the host then rebuilds under
``inject.suppress_transient()`` and retries, at most ``max_recoveries``
times for one failing step, after which the march fails explicitly with
the last healthy state.  The frozen march has no ladder: the slots after a
blocked step retry it and record the failed attempts.

Trace-time binding.  The step, scan and segment closures go through
``robust.inject.traced``: the fault schedule, the SpGEMM path and the
observability mode in force at a closure's first call hold for every
later call, so a segment rebuilt under ``suppress_transient()`` stays
clean, as the reference's fresh trace does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gamg
from repro_torch.core.block_coo import set_values_coo
from repro_torch.obs import metrics as obs_metrics
from repro_torch.robust import health, inject
from repro_torch.sim.staleness import (
    StalenessConfig,
    StalenessState,
    staleness_init,
    staleness_update,
)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """March knobs."""

    n_steps: int
    seg_len: int = 16            # max steps per adaptive segment
    rtol: float = 1e-8
    maxiter: int = 200
    warm_start: bool = True      # x0 = previous iterate (False: cold CG)
    staleness: StalenessConfig = StalenessConfig()
    max_recoveries: int = 2      # rebuild retries for one blocked step


class MarchCarry(NamedTuple):
    """The device-resident march state."""

    x: torch.Tensor              # last healthy solution
    scen: Any                    # scenario evolution state
    stale: StalenessState
    step: torch.Tensor           # int32 next global step index


class StepRecord(NamedTuple):
    """Per-step diagnostics (device scalars; buffers inside a segment)."""

    iters: torch.Tensor          # int32 CG iterations
    relres: torch.Tensor         # final relative residual
    status: torch.Tensor         # int32 SolveHealth status code
    tripped: torch.Tensor        # bool: staleness tripped after this step
    coeff_drift: torch.Tensor    # relative coefficient drift vs the rebuild


@dataclasses.dataclass
class SegmentInfo:
    """One frozen-hierarchy segment of the march (host bookkeeping)."""

    start: int           # global step index of the segment's first step
    steps: int           # steps advanced inside the segment
    setup_id: int        # which gamg.setup built its hierarchy
    reason: str          # "tripped" | "blocked" | "budget" | "done"
    iters: int           # CG iterations spent in the segment


@dataclasses.dataclass
class MarchResult:
    """Host-side march summary; per-step arrays cover advanced steps."""

    x: torch.Tensor              # final (last healthy) solution
    scen_state: Any              # final scenario state
    E: torch.Tensor              # coefficient fields at the final state
    nu: torch.Tensor
    steps_done: int
    n_setups: int
    n_recoveries: int
    status: str                  # "ok" | "failed"
    iters: np.ndarray            # (steps_done,) int
    relres: np.ndarray
    step_status: np.ndarray      # (steps_done,) SolveHealth codes
    tripped: np.ndarray          # (steps_done,) bool
    coeff_drift: np.ndarray
    segments: List[SegmentInfo]
    attempts: List[dict]         # failed (non-advancing) step attempts
    worst_status: int            # health.worst_status over all attempts

    @property
    def total_iters(self) -> int:
        return int(self.iters.sum())


def _tree_where(pred: torch.Tensor, a, b):
    """Elementwise select over two identically structured carries
    (tensors, tuples and named tuples)."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    vals = [_tree_where(pred, u, v) for u, v in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else type(a)(vals)


def _record_buffers(n: int, like: torch.Tensor, drift_dtype) -> StepRecord:
    """Record buffers of ``n`` slots on ``like``'s device, filled as the
    reference's (-1, NaN, False)."""
    dev = like.device

    def full(value, dtype):
        return torch.full((n,), value, dtype=dtype, device=dev)

    return StepRecord(iters=full(-1, torch.int32),
                      relres=full(float("nan"), like.dtype),
                      status=full(-1, torch.int32),
                      tripped=full(False, torch.bool),
                      coeff_drift=full(float("nan"), drift_dtype))


def _store(recs: StepRecord, k: int, rec: StepRecord) -> None:
    """Write one step's record into slot ``k`` (device to device)."""
    for buf, v in zip(recs, rec):
        buf[k] = v


def make_step(setupd, assembler, scenario, cfg: MarchConfig):
    """The march step ``(carry, b, *, spgemm_path=None) -> (carry',
    record, blocked)``: the scenario law, device assembly, the state-gated
    recompute and the warm-started solve.  The carry advances only when
    the solve is ``HEALTHY``; a blocked step leaves the trajectory
    (solution, scenario state, monitor, step counter) untouched and
    returns ``blocked`` (a device bool)."""
    gamg._check_assembler(setupd, assembler)

    def step(carry: MarchCarry, b: torch.Tensor, *, spgemm_path=None):
        E, nu, scen2 = scenario.step_fields(carry.scen, carry.x,
                                            carry.step)
        hier = gamg.recompute(setupd, assembler.coo_data(E, nu),
                              spgemm_path=spgemm_path)
        x0 = carry.x if cfg.warm_start else None
        res = gamg.hier_solve(setupd, hier, b, x0, rtol=cfg.rtol,
                              maxiter=cfg.maxiter)
        ok = res.health.status == health.HEALTHY
        # the count lives on the host; a fill puts it on the device
        iters = torch.full((), res.iters, dtype=torch.int32,
                           device=b.device)
        stale2 = staleness_update(carry.stale, iters, E, cfg.staleness)
        advanced = MarchCarry(x=res.x, scen=scen2, stale=stale2,
                              step=carry.step + 1)
        carry2 = _tree_where(ok, advanced, carry)
        rec = StepRecord(iters=iters, relres=res.relres,
                         status=res.health.status,
                         tripped=ok & stale2.tripped,
                         coeff_drift=stale2.coeff_drift)
        return carry2, rec, ~ok

    return step


def init_carry(scenario, b: torch.Tensor) -> MarchCarry:
    """Initial march carry: zero displacement, pristine scenario state,
    the monitor referenced against the step-0 coefficient field."""
    scen = scenario.init_state()
    x = torch.zeros_like(b)
    step = torch.zeros((), dtype=torch.int32, device=b.device)
    E, _, _ = scenario.step_fields(scen, x, step)
    return MarchCarry(x=x, scen=scen, stale=staleness_init(E), step=step)


def make_scan_march(setupd, assembler, scenario, cfg: MarchConfig, *,
                    unroll: bool = False):
    """The frozen-hierarchy march ``(b, carry) -> (carry',
    StepRecord[(n_steps,)])``: ``cfg.n_steps`` steps on one hierarchy.  A
    blocked step stops advancing and the remaining slots retry it (and
    record the failed attempts), so the final ``carry.step`` says how far
    the march got.  ``unroll`` is the reference's switch between its
    rolled and unrolled scan; an eager loop is one program either way,
    step for step the same as ``make_step_fn``'s."""
    step = make_step(setupd, assembler, scenario, cfg)

    def run(b, carry, *, spgemm_path):
        recs = _record_buffers(cfg.n_steps, b,
                               carry.stale.coeff_drift.dtype)
        for k in range(cfg.n_steps):
            carry, rec, _ = step(carry, b, spgemm_path=spgemm_path)
            _store(recs, k, rec)
        return carry, recs

    return inject.traced(run, gamg._spgemm_knob(setupd))


def make_step_fn(setupd, assembler, scenario, cfg: MarchConfig):
    """The step as a callable ``(carry, b) -> (carry', record, blocked)``
    with the hot closures' binding: the hand-rolled march of the parity
    tests."""
    return inject.traced(make_step(setupd, assembler, scenario, cfg),
                         gamg._spgemm_knob(setupd))


def make_segment(setupd, assembler, scenario, cfg: MarchConfig):
    """One frozen-hierarchy adaptive segment: ``(b, carry, n_steps) -> (k,
    carry', StepRecord[(seg_len,)], blocked)``.

    Runs up to ``cfg.seg_len`` steps, leaving early when the march
    completes, the monitor trips or a step blocks.  ``k`` (a host int)
    counts attempts written to the record buffers; when ``blocked`` (a
    device bool) the last attempt, slot ``k - 1``, did not advance the
    carry."""
    step = make_step(setupd, assembler, scenario, cfg)
    L = cfg.seg_len

    def run(b, carry, n_steps, *, spgemm_path):
        recs = _record_buffers(L, b, carry.stale.coeff_drift.dtype)
        blocked = torch.zeros((), dtype=torch.bool, device=b.device)
        k = 0
        # the exit test: one host bool per step
        while k < L and bool((carry.step < n_steps) & ~carry.stale.tripped
                             & ~blocked):
            carry, rec, blocked = step(carry, b, spgemm_path=spgemm_path)
            _store(recs, k, rec)
            k += 1
        return k, carry, recs, blocked

    return inject.traced(run, gamg._spgemm_knob(setupd))


def _setup_from_fields(prob, E, nu, setup_opts: dict):
    """Host re-coarsening: assemble the operator at the current fields
    (cached COO plan) and run the cold ``gamg.setup``."""
    A = set_values_coo(prob.coo_plan, prob.assembler.value_stream(E, nu))
    return gamg.setup(A, prob.B, **setup_opts)


def _rows(recs: StepRecord, n: int) -> List[dict]:
    """The first ``n`` records as host dicts (one transfer per field)."""
    host = {key: v.cpu().numpy() for key, v in recs._asdict().items()}
    return [{key: v[i].item() for key, v in host.items()} for i in range(n)]


def march(prob, scenario, cfg: MarchConfig, *, mode: str = "adaptive",
          b: Optional[torch.Tensor] = None,
          setup_opts: Optional[dict] = None) -> MarchResult:
    """Run the quasi-static march (modes in the module docstring).

    ``prob`` is an assembled ``ElasticityProblem`` on the device assembly
    path (the march needs its ``DeviceAssembler`` and COO plan); the march
    runs on its device.  ``setup_opts`` goes to every ``gamg.setup``
    (re)build; ``None`` or ``{}`` is ``setup``'s defaults (the MIS
    coarsener)."""
    if prob.assembler is None:
        raise ValueError(
            "the march needs the device assembly path: assemble with "
            "path='device' (the default)")
    if mode not in ("adaptive", "frozen", "resetup"):
        raise ValueError(f"invalid march mode {mode!r}: expected "
                         f"'adaptive', 'frozen' or 'resetup'")
    if mode == "resetup":
        cfg = dataclasses.replace(cfg, seg_len=1)
    assembler = prob.assembler
    b = prob.b if b is None else b
    setup_opts = dict(setup_opts or {})
    reg = obs_metrics.default_registry()
    labels = {"mode": mode}

    fields_fn = scenario.step_fields
    carry = init_carry(scenario, b)
    E, nu, _ = fields_fn(carry.scen, carry.x, carry.step)
    setupd = _setup_from_fields(prob, E, nu, setup_opts)
    n_setups, n_recoveries = 1, 0
    reg.counter("march/setups",
                "gamg.setup builds performed by the march").inc(
                    1, labels=labels)

    rows: List[dict] = []
    attempts: List[dict] = []
    segments: List[SegmentInfo] = []
    status = "ok"

    if mode == "frozen":
        runner = make_scan_march(setupd, assembler, scenario, cfg)
        carry, recs = runner(b, carry)
        for row in _rows(recs, cfg.n_steps):
            (rows if row["status"] == health.HEALTHY
             else attempts).append(row)
        steps_done = int(carry.step)
        if steps_done < cfg.n_steps:
            status = "failed"   # frozen mode has no recovery ladder
        segments.append(SegmentInfo(
            start=0, steps=steps_done, setup_id=0,
            reason="done" if status == "ok" else "blocked",
            iters=int(sum(r["iters"] for r in rows))))
    else:
        seg_runner = make_segment(setupd, assembler, scenario, cfg)
        need_rebuild = False
        retry_pending = False
        fail_step, fails_here = -1, 0
        while int(carry.step) < cfg.n_steps:
            seg_start = int(carry.step)
            ctx = (inject.suppress_transient() if retry_pending
                   else contextlib.nullcontext())
            with ctx:
                if need_rebuild:
                    E, nu, _ = fields_fn(carry.scen, carry.x, carry.step)
                    setupd = _setup_from_fields(prob, E, nu, setup_opts)
                    seg_runner = make_segment(setupd, assembler,
                                              scenario, cfg)
                    carry = carry._replace(stale=staleness_init(E))
                    n_setups += 1
                    reg.counter("march/setups").inc(1, labels=labels)
                    need_rebuild = False
                k, carry, recs, blocked = seg_runner(b, carry, cfg.n_steps)
            retry_pending = False
            blocked = bool(blocked)
            tripped = bool(carry.stale.tripped)
            seg_all = _rows(recs, k)
            n_ok = k - 1 if blocked else k
            seg_rows = seg_all[:n_ok]
            rows.extend(seg_rows)
            seg_iters = int(sum(r["iters"] for r in seg_rows))
            if blocked:
                reason = "blocked"
            elif tripped:
                reason = "tripped"
            elif int(carry.step) >= cfg.n_steps:
                reason = "done"
            else:
                reason = "budget"
            segments.append(SegmentInfo(
                start=seg_start, steps=n_ok, setup_id=n_setups - 1,
                reason=reason, iters=seg_iters))
            reg.counter("march/segments",
                        "frozen-hierarchy march segments").inc(
                            1, labels=labels)
            reg.histogram("march/segment_steps",
                          "steps advanced per frozen segment",
                          buckets=obs_metrics.ITER_BUCKETS).observe(
                              n_ok, labels=labels)
            if blocked:
                bad = dict(seg_all[k - 1])
                bad["step"] = int(carry.step)
                attempts.append(bad)
                if int(carry.step) == fail_step:
                    fails_here += 1
                else:
                    fail_step, fails_here = int(carry.step), 1
                if fails_here > cfg.max_recoveries:
                    status = "failed"
                    break
                # recovery: rebuild against the last healthy trajectory
                # point with transient faults suppressed, then retry
                n_recoveries += 1
                reg.counter("march/recoveries",
                            "blocked-step rebuild retries").inc(
                                1, labels=labels)
                need_rebuild, retry_pending = True, True
            elif tripped or mode == "resetup":
                need_rebuild = True

    reg.counter("march/steps", "march steps advanced").inc(
        len(rows), labels=labels)
    reg.counter("march/solve_iters", "total CG iterations").inc(
        sum(r["iters"] for r in rows), labels=labels)

    E, nu, _ = fields_fn(carry.scen, carry.x, carry.step)
    all_status = [r["status"] for r in rows] + \
        [a["status"] for a in attempts]
    return MarchResult(
        x=carry.x, scen_state=carry.scen, E=E, nu=nu,
        steps_done=int(carry.step), n_setups=n_setups,
        n_recoveries=n_recoveries, status=status,
        iters=np.asarray([r["iters"] for r in rows], np.int64),
        relres=np.asarray([r["relres"] for r in rows]),
        step_status=np.asarray([r["status"] for r in rows], np.int64),
        tripped=np.asarray([r["tripped"] for r in rows], bool),
        coeff_drift=np.asarray([r["coeff_drift"] for r in rows]),
        segments=segments, attempts=attempts,
        worst_status=int(health.worst_status(
            np.asarray(all_status))) if all_status else health.HEALTHY)
