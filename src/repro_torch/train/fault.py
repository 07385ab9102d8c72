"""Fault tolerance: restart orchestration + straggler mitigation (torch
twin of ``repro.train.fault``: plain Python and numpy, on the port's
``CheckpointManager``).

At thousand-node scale the failure model is: (a) a host dies mid-run
(restart from the last complete checkpoint), (b) a host dies mid-*save*
(the partial checkpoint must be detected and skipped), (c) a host runs slow
(straggler) and gates every synchronous collective.

``run_with_restarts`` drives a step function with checkpoint/resume and an
injectable failure schedule; because the data pipeline is a pure function of
(seed, step), a restarted run reproduces the uninterrupted run bit-for-bit —
asserted by the tests.

``StragglerMonitor`` implements the detection half of straggler mitigation
(robust z-score on per-host step durations); the mitigation hook reassigns
the slow host's data shard — in this single-process harness the reassignment
is recorded and tested, the collective semantics being host-count invariant
by construction of ``DataConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RestartReport:
    final_step: int
    restarts: int
    losses: List[float]
    resumed_from: List[int]


def run_with_restarts(init_state: Callable[[], Dict],
                      step_fn: Callable[[Dict, int], Dict],
                      loss_of: Callable[[Dict], float],
                      ckpt: CheckpointManager,
                      total_steps: int,
                      save_every: int = 5,
                      fail_at: Sequence[int] = (),
                      max_restarts: int = 10) -> RestartReport:
    """Drive training with checkpoint/restart.  ``fail_at`` injects a
    failure *before* those global steps complete (each fires once)."""
    pending_failures = sorted(set(fail_at))
    restarts = 0
    resumed_from: List[int] = []
    losses: List[float] = [float("nan")] * total_steps

    while True:
        state = init_state()
        start = 0
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start, state, extra = restored
            resumed_from.append(start)
        try:
            for step in range(start, total_steps):
                if pending_failures and step == pending_failures[0]:
                    pending_failures.pop(0)
                    raise SimulatedFailure(f"injected at step {step}")
                state = step_fn(state, step)
                losses[step] = loss_of(state)
                if (step + 1) % save_every == 0 or step + 1 == total_steps:
                    ckpt.save(step + 1, state)
            return RestartReport(final_step=total_steps, restarts=restarts,
                                 losses=losses, resumed_from=resumed_from)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


@dataclasses.dataclass
class StragglerMonitor:
    """Robust per-host step-duration anomaly detector."""

    n_hosts: int
    window: int = 16
    threshold: float = 3.0       # robust z-score
    history: Optional[np.ndarray] = None
    reassignments: List[int] = dataclasses.field(default_factory=list)

    def observe(self, durations: Sequence[float]) -> List[int]:
        """Record one step's per-host durations; returns flagged hosts."""
        d = np.asarray(durations, dtype=np.float64)[None]
        self.history = d if self.history is None else \
            np.concatenate([self.history, d], axis=0)[-self.window:]
        med = np.median(self.history)
        mad = np.median(np.abs(self.history - med)) + 1e-9
        z = (self.history[-1] - med) / (1.4826 * mad)
        flagged = [i for i in range(self.n_hosts)
                   if z[i] > self.threshold]
        return flagged

    def mitigate(self, flagged: Sequence[int], num_hosts: int) -> Dict:
        """Reassign a flagged host's data shard to its neighbor (recorded;
        the data pipeline regenerates any shard from (seed, step, host))."""
        plan = {}
        for h in flagged:
            plan[h] = (h + 1) % num_hosts
            self.reassignments.append(h)
        return plan
