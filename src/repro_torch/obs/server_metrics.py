"""End-to-end ``AMGSolveServer`` instrumentation (torch twin of
``repro.obs.server_metrics``; the same instrument names).

``ServerMetrics`` is the host-side measurement surface the solve server
owns: every request's queue wait and end-to-end latency, every batch's
blocked solve wall time, padding efficiency per flush, recompute timing
and per-status outcome counts — the numbers a deployment dashboard needs
to answer "is the reuse model paying off".

Always on: these are pure host clocks and Python counters around calls
the server already makes (the solve wall clock stops after the results
were copied to the host, which the server does anyway), so they add no
device work.  ``retry_seconds`` times each flagged column's retry
(``AMGSolveServer(recover=)``), and ``status_recovered_total`` counts the
retries that came back healthy.

Instrument names (all under the server's private ``MetricsRegistry``):

========================================  ==========  ====================
name                                      kind        meaning
========================================  ==========  ====================
``server/queue_wait_seconds``             histogram   submit -> batch start
``server/solve_wall_seconds``             histogram   blocked panel solve
``server/request_latency_seconds``        histogram   submit -> report
                                                      (retries included)
``server/recompute_seconds``              histogram   ``update_operator``
``server/coeff_update_seconds``           histogram   ``update_coefficients``
``server/retry_seconds``                  histogram   ``_retry_column``
``server/padding_efficiency``             gauge       useful/total columns
                                                      (cumulative)
``server/pending``                        gauge       queue depth
``server/requests_total``                 counter     accepted submits
``server/rejected_total``                 counter     validation rejects
``server/batches_total``                  counter     panel solves
``server/padded_columns_total``           counter     padding columns
``server/solves_k{k}_total``              counter     per-bucket solves
``server/status_{s}_total``               counter     report outcomes
``server/iters``                          histogram   per-request iterations
========================================  ==========  ====================
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.obs.metrics import ITER_BUCKETS, MetricsRegistry

STATUSES = ("ok", "degraded", "failed", "recovered")


class ServerMetrics:
    """The solve server's measurement surface (one registry per server)."""

    def __init__(self, buckets: Sequence[int],
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        r = self.registry
        self.queue_wait = r.histogram(
            "server/queue_wait_seconds",
            help="per-request wait from submit to its batch starting")
        self.solve_wall = r.histogram(
            "server/solve_wall_seconds",
            help="blocked wall time of one bucketed panel solve")
        self.request_latency = r.histogram(
            "server/request_latency_seconds",
            help="per-request submit-to-report latency, retries included")
        self.recompute_seconds = r.histogram(
            "server/recompute_seconds",
            help="blocked wall time of update_operator")
        self.coeff_update_seconds = r.histogram(
            "server/coeff_update_seconds",
            help="blocked wall time of update_coefficients")
        self.retry_seconds = r.histogram(
            "server/retry_seconds",
            help="blocked wall time of one flagged-column retry")
        self.iters = r.histogram(
            "server/iters", help="per-request CG iterations",
            buckets=ITER_BUCKETS)
        self.padding_efficiency = r.gauge(
            "server/padding_efficiency",
            help="useful columns / solved columns, cumulative over flushes")
        self.pending = r.gauge("server/pending", help="queue depth")
        self.requests = r.counter("server/requests_total",
                                  help="accepted submits")
        self.rejected = r.counter("server/rejected_total",
                                  help="submit validation rejects")
        self.batches = r.counter("server/batches_total", help="panel solves")
        self.padded_columns = r.counter("server/padded_columns_total",
                                        help="padding columns solved")
        self._useful_columns = 0
        self._total_columns = 0
        self._solves_k = {
            int(k): r.counter(f"server/solves_k{int(k)}_total",
                              help=f"panel solves at bucket width {int(k)}")
            for k in buckets}
        self._status = {
            s: r.counter(f"server/status_{s}_total",
                         help=f"requests reported {s}")
            for s in STATUSES}

    # ---- recording hooks the server calls --------------------------------
    def record_batch(self, k_bucket: int, n_requests: int,
                     solve_seconds: float) -> None:
        """One drained panel: bucket width, real request count, blocked
        solve wall time.  Updates the cumulative padding-efficiency gauge
        (useful columns / solved columns across the server's lifetime)."""
        self.batches.inc()
        self.solve_wall.observe(solve_seconds)
        self._solves_k[int(k_bucket)].inc()
        self.padded_columns.inc(int(k_bucket) - int(n_requests))
        self._useful_columns += int(n_requests)
        self._total_columns += int(k_bucket)
        if self._total_columns:
            self.padding_efficiency.set(
                self._useful_columns / self._total_columns)

    def record_request(self, status: str, iters: int, queue_wait_s: float,
                       latency_s: float) -> None:
        """One finished report.  ``latency_s`` is submit-to-report and must
        include any recovery retry the request triggered — the client
        waited through the retry, so its latency owns it."""
        self._status[status].inc()
        self.iters.observe(iters)
        self.queue_wait.observe(queue_wait_s)
        self.request_latency.observe(latency_s)

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict summary (medians/p99 via the histograms' estimator)."""
        lat = self.request_latency
        return {
            "requests": self.requests.value(),
            "rejected": self.rejected.value(),
            "batches": self.batches.value(),
            "padded_columns": self.padded_columns.value(),
            "padding_efficiency": self.padding_efficiency.value(),
            "pending": self.pending.value(),
            "status": {s: c.value() for s, c in self._status.items()},
            "solves_per_k": {k: c.value()
                             for k, c in self._solves_k.items()},
            "latency_p50_s": lat.quantile(0.5),
            "latency_p99_s": lat.quantile(0.99),
            "solve_wall_p50_s": self.solve_wall.quantile(0.5),
            "queue_wait_p50_s": self.queue_wait.quantile(0.5),
        }

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def to_jsonl(self, fileobj=None, timestamp: Optional[float] = None
                 ) -> str:
        return self.registry.to_jsonl(fileobj, timestamp)
