"""repro_torch.obs — solver observability (torch twin of ``repro.obs``).

* ``metrics``        process-local ``MetricsRegistry`` (counters, gauges,
                     histograms), ``Timer`` spans, JSONL and Prometheus
                     exporters;
* ``trace``          two tiers of ``record_function`` ranges: ``span``
                     on every kernel family, V-cycle and recompute stage,
                     and the device ``CycleTally`` counter carry — both
                     absent under ``REPRO_TORCH_OBS=off``; ``host_span``
                     around host syncs and the server's host phases,
                     recorded whenever a profiler is recording;
* ``model``          the analytic HBM-traffic model the counters carry;
* ``server_metrics`` ``AMGSolveServer`` instrumentation;
* ``transfer``       host-to-device bytes of a call, counted at the aten
                     level.

Knob: ``REPRO_TORCH_OBS=off|spans|counters`` (default off), resolved by
``repro_torch.kernels.backend.resolve_obs``.
"""
from repro_torch.obs.metrics import (          # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    default_registry,
    parse_prometheus,
)
from repro_torch.obs.server_metrics import ServerMetrics   # noqa: F401
from repro_torch.obs.trace import (            # noqa: F401
    CycleTally,
    attach_model_bytes,
    counters_enabled,
    describe_tally,
    host_span,
    span,
    spans_enabled,
    use,
    zero_tally,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ServerMetrics",
    "Timer", "default_registry", "parse_prometheus", "CycleTally",
    "attach_model_bytes", "counters_enabled", "describe_tally", "host_span",
    "span", "spans_enabled", "use", "zero_tally",
]
