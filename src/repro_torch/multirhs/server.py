"""Hierarchy-reusing solve server: request streams -> bucketed panel solves
(torch twin of ``repro.multirhs.server``).

One cold ``GAMGSetup`` serves many solves — load cases, client requests,
Newton steps.  The server accepts a stream of right-hand sides against the
cached hierarchy and drains it in panels:

* requests are batched into column panels padded up to a small set of
  bucket widths (default k in {1, 2, 4, 8, 16});
* padding columns are zero vectors — inactive from the first masked-PCG
  iteration, they cost panel columns but no extra iterations;
* each request gets back its own column, iteration count and relative
  residual (the per-column masking keeps those equal to a dedicated
  single-RHS solve);
* ``update_operator`` refreshes the hierarchy through the hot recompute
  (new values, same structure) without touching the buckets;
  ``update_coefficients`` (with ``assembler=``) does so from new
  per-element material fields: device assembly, then the recompute, so a
  client ships two ``(n_elements,)`` arrays, not a value stream.

Requests arrive as numpy f64 and reports return numpy; each panel is
built on the host and moved to the setup's device once per batch, and the
panel solve runs there (on CUDA through the ``block_spmm`` and panel
``fused_smoother`` kernels).

A malformed request — wrong shape, a payload that does not convert to the
panel dtype, or non-finite values — is rejected at ``submit`` with a
``ValueError`` before it can poison a panel.  Corruption that arises in
flight is quarantined per column by the masked PCG's health flags: the
column's report says ``status="degraded"`` (usable best iterate) or
``status="failed"`` (solution zeroed), and its neighbours finish
untouched.  With a ``recover=`` policy (or ``REPRO_TORCH_RECOVER``) a
flagged column gets one bounded retry as a width-1 panel on a fresh
hierarchy (from the stored fine values, or from the last coefficient
fields through the device assembly) under
``inject.suppress_transient()``: a transient fault is gone from the
retry and the report says ``status="recovered"``; a persistent one keeps
its explicit failure.
"""
from __future__ import annotations

import time
from typing import Hashable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gamg
from repro_torch.multirhs.block_krylov import make_block_solve
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.server_metrics import ServerMetrics
from repro_torch.robust import inject
from repro_torch.robust.health import (
    BREAKDOWN,
    HEALTHY,
    NONFINITE,
    STATUS_NAMES,
)


class SolveReport(NamedTuple):
    request_id: Hashable
    x: np.ndarray         # (n,) solution for this request
    iters: int
    relres: float
    converged: bool
    k_bucket: int         # panel width the request was served in
    status: str = "ok"    # "ok" | "degraded" | "failed" | "recovered"
    health: int = HEALTHY  # raw health code (STATUS_NAMES)
    # submit -> report latency, submit -> batch-start wait, and — when the
    # server records history — this request's per-iteration residual
    # norms ((maxiter,), NaN past its final iteration)
    latency_s: float = 0.0
    queue_wait_s: float = 0.0
    history: "np.ndarray | None" = None


class AMGSolveServer:
    """Setup-once, serve-many front end over a cached GAMG hierarchy; runs
    on the device of the setup's operators."""

    def __init__(self, setupd: gamg.GAMGSetup, a_fine_data, *,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 rtol: float = 1e-8, maxiter: int = 200,
                 assembler=None, recover=None,
                 record_history: bool | None = None):
        from repro_torch.kernels.backend import resolve_recover
        buckets_in = [int(k) for k in buckets]
        if not buckets_in:
            raise ValueError("buckets must be a non-empty sequence of "
                             "panel widths")
        if min(buckets_in) < 1:
            raise ValueError(f"bucket widths must be positive ints, got "
                             f"{buckets_in}")
        if len(set(buckets_in)) != len(buckets_in):
            raise ValueError(f"duplicate bucket widths in {buckets_in}: "
                             f"list each width once")
        self.setupd = setupd
        self.buckets = tuple(sorted(buckets_in))
        self.n = int(setupd.stats["level_rows"][0])
        self.device = setupd.device
        # panels are assembled at the policy's Krylov dtype: every rhs is
        # cast to it at submit, so no request's dtype decides the panel's
        self.dtype = torch.empty(
            (), dtype=setupd.precision.krylov_dtype).numpy().dtype
        # per-request residual histories: None follows the observability
        # knob (on whenever it is not "off"), as the reference's default
        if record_history is None:
            record_history = obs_trace.resolve() != "off"
        self._record_history = bool(record_history)
        self._rtol, self._maxiter = rtol, maxiter
        self._solve = make_block_solve(setupd, rtol=rtol, maxiter=maxiter,
                                       record_history=self._record_history)
        self._recompute = gamg.make_recompute(setupd)
        self._a_fine_data = self._on_device(a_fine_data)
        self.hierarchy = self._recompute(self._a_fine_data)
        # one bounded retry of each flagged column (None disables)
        self.recover = resolve_recover(recover)
        # optional device-assembly binding, built here so a mismatched
        # plan fails at construction, not at the first update
        self.assembler = assembler
        self._coeff_recompute = None if assembler is None else \
            gamg.make_coeff_recompute(setupd, assembler)
        self._coeff_fields = None       # the last (E, nu), for retries
        self._pending: List[tuple] = []
        self._next_id = 0
        self.stats = {
            "requests": 0, "batches": 0, "padded_columns": 0,
            "recomputes": 0, "coefficient_updates": 0,
            "solves_per_k": {k: 0 for k in self.buckets},
            "rejected": 0, "degraded": 0, "failed": 0, "recovered": 0,
        }
        self._metrics = ServerMetrics(self.buckets)

    def _on_device(self, a) -> torch.Tensor:
        """Fine values on the hierarchy's device at their own dtype:
        ``recompute`` casts them to the hierarchy dtype and, under a mixed
        policy, builds the Krylov operator from them as given (the
        reference keeps them as given, too)."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device)
        return torch.tensor(np.asarray(a), device=self.device)

    # ---- observability ---------------------------------------------------
    def metrics(self) -> ServerMetrics:
        """The server's measurement surface (latency/padding histograms,
        outcome counters; export via ``.to_prometheus()``/``.to_jsonl()``)."""
        return self._metrics

    def snapshot(self) -> dict:
        """One plain-dict health/throughput summary (dashboard poll)."""
        return self._metrics.snapshot()

    # ---- operator lifecycle ---------------------------------------------
    def update_operator(self, a_fine_data) -> None:
        """Hot path: new fine values, same structure (the PtAP chain)."""
        self._a_fine_data = self._on_device(a_fine_data)
        self._coeff_fields = None
        with self._metrics.registry.timer("server/recompute_seconds") as t:
            self.hierarchy = t.block(self._recompute(self._a_fine_data))
        self.stats["recomputes"] += 1

    def update_coefficients(self, E, nu) -> None:
        """Hot path: new material fields (per-element arrays or scalars):
        device assembly through the cached COO plan, then the recompute.
        Only the two fields cross to the device."""
        if self.assembler is None:
            raise ValueError(
                "update_coefficients needs an assembler: construct the "
                "server with assembler=problem.assembler (device assembly "
                "path)")
        E, nu = self.assembler.as_fields(E, nu)
        self._coeff_fields = (E, nu)
        with self._metrics.registry.timer(
                "server/coeff_update_seconds") as t:
            self.hierarchy = t.block(self._coeff_recompute(E, nu))
        self.stats["recomputes"] += 1
        self.stats["coefficient_updates"] += 1

    # ---- request stream --------------------------------------------------
    def _reject(self, msg: str, cause=None):
        self.stats["rejected"] += 1
        self._metrics.rejected.inc()
        raise ValueError(msg) from cause

    def submit(self, b, request_id: Optional[Hashable] = None) -> Hashable:
        """Queue one right-hand side; returns its request id.

        A rhs that is the wrong shape, does not convert to the panel
        dtype, or carries NaN/Inf is rejected here with a ``ValueError``.
        """
        try:
            b = np.asarray(b, dtype=self.dtype)
        except (TypeError, ValueError) as e:
            self._reject(f"rhs does not convert to the panel dtype "
                         f"{self.dtype}: {e}", e)
        if b.shape != (self.n,):
            self._reject(f"rhs shape {b.shape} != ({self.n},)")
        if not np.isfinite(b).all():
            self._reject(f"rhs contains {int((~np.isfinite(b)).sum())} "
                         f"non-finite values — rejected before panel "
                         f"assembly")
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        self._pending.append((request_id, b, time.perf_counter()))
        self._metrics.requests.inc()
        self._metrics.pending.set(len(self._pending))
        return request_id

    def _bucket_for(self, count: int) -> int:
        """Smallest bucket width holding ``count`` columns; a count above
        the largest bucket raises (``flush`` never makes one)."""
        if count < 1:
            raise ValueError(f"chunk must hold at least one request, "
                             f"got {count}")
        if count > self.buckets[-1]:
            raise ValueError(f"chunk of {count} requests exceeds the "
                             f"largest bucket width {self.buckets[-1]}")
        return next(k for k in self.buckets if k >= count)

    # ---- flagged-column recovery ----------------------------------------
    def _retry_column(self, b: np.ndarray):
        """One bounded retry of a flagged column: a fresh hierarchy (the
        coefficient fields through the device assembly when the last
        update was one) and a width-1 panel solve, under
        ``suppress_transient``."""
        with self._metrics.registry.timer("server/retry_seconds") as t, \
                inject.suppress_transient():
            solve = make_block_solve(self.setupd, rtol=self._rtol,
                                     maxiter=self._maxiter)
            if self._coeff_fields is not None:
                coeff = gamg.make_coeff_recompute(self.setupd,
                                                  self.assembler)
                hier = coeff(*self._coeff_fields)
            else:
                hier = gamg.make_recompute(self.setupd)(self._a_fine_data)
            return t.block(solve(hier, torch.from_numpy(
                np.array(b[:, None])).to(self.device)))

    @staticmethod
    def _classify(code: int, converged: bool) -> str:
        if code == HEALTHY and converged:
            return "ok"
        if code in (BREAKDOWN, NONFINITE):
            return "failed"
        return "degraded"       # maxiter / stagnation: best iterate usable

    def flush(self) -> List[SolveReport]:
        """Drain the queue: bucketed, padded panel solves; one report per
        request, in submission order.

        A flagged column degrades or fails its own report only.  Failed
        columns return zeros, degraded columns their best iterate; neither
        carries a NaN.  With ``self.recover`` set, a flagged column gets
        one retry (``_retry_column``) first.  ``queue_wait_s`` runs from
        submit to the batch starting, ``latency_s`` from submit to the
        report, after any retry.
        """
        reports: List[SolveReport] = []
        kmax = self.buckets[-1]
        while self._pending:
            chunk = self._pending[:kmax]
            del self._pending[:kmax]
            self._metrics.pending.set(len(self._pending))
            t_batch = time.perf_counter()
            k = self._bucket_for(len(chunk))
            B = np.zeros((self.n, k), self.dtype)
            for j, (_, b, _) in enumerate(chunk):
                B[:, j] = b
            out = self._solve(self.hierarchy,
                              torch.from_numpy(B).to(self.device))
            res, hist = out if self._record_history else (out, None)
            x = res.x.cpu().numpy()
            iters = res.iters.cpu().numpy()
            relres = res.relres.cpu().numpy()
            conv = res.converged.cpu().numpy()
            codes = res.health.status.cpu().numpy()
            hist_np = None if hist is None else hist.cpu().numpy()
            # every result is on the host now: the clock stop is honest
            solve_s = time.perf_counter() - t_batch
            for j, (rid, b_j, t_sub) in enumerate(chunk):
                code = int(codes[j])
                status = self._classify(code, bool(conv[j]))
                x_j, it_j = x[:, j], int(iters[j])
                rr_j = float(relres[j])
                if status != "ok" and self.recover is not None:
                    r1 = self._retry_column(b_j)
                    c1 = int(r1.health.status[0])
                    if c1 == HEALTHY and bool(r1.converged[0]):
                        status, code = "recovered", c1
                        x_j = r1.x[:, 0].cpu().numpy()
                        it_j = int(r1.iters[0])
                        rr_j = float(r1.relres[0])
                if status == "failed":
                    # explicit failure: never hand back a maybe-iterate
                    x_j = np.zeros_like(x_j)
                elif not np.isfinite(x_j).all():  # pragma: no cover
                    # the masked PCG keeps flagged columns finite; if that
                    # ever breaks, fail the report rather than leak a NaN
                    status, x_j = "failed", np.zeros_like(x_j)
                if status != "ok":
                    self.stats[status] += 1
                queue_wait = t_batch - t_sub
                latency = time.perf_counter() - t_sub
                self._metrics.record_request(status, it_j, queue_wait,
                                             latency)
                reports.append(SolveReport(
                    request_id=rid, x=x_j, iters=it_j, relres=rr_j,
                    converged=bool(conv[j]) or status == "recovered",
                    k_bucket=k, status=status, health=code,
                    latency_s=latency, queue_wait_s=queue_wait,
                    history=None if hist_np is None else hist_np[:, j]))
            self.stats["requests"] += len(chunk)
            self.stats["batches"] += 1
            self.stats["padded_columns"] += k - len(chunk)
            self.stats["solves_per_k"][k] += 1
            self._metrics.record_batch(k, len(chunk), solve_s)
        return reports

    def serve(self, rhs_list: Sequence) -> List[SolveReport]:
        """Convenience: submit a batch of RHS vectors and flush."""
        for b in rhs_list:
            self.submit(b)
        return self.flush()


__all__ = ["AMGSolveServer", "SolveReport", "STATUS_NAMES"]
