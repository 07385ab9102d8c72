"""Process-local solver metrics: counters, gauges, histograms, timers
(torch twin of the host half of ``repro.obs.metrics``).

Every span here that is handed device results synchronises their CUDA
device before it stops its clock, and the first observation of a phase
can be filed apart (``measure``) so first-use costs (kernel build,
library handles) never pollute the steady-state distribution.

Three instrument kinds, Prometheus-shaped:

* ``Counter``   — monotone float (requests served, faults detected);
* ``Gauge``     — last-write-wins float (padding efficiency, queue depth);
* ``Histogram`` — cumulative-bucket distribution with solver-scale
                  default buckets (1 us .. 100 s, log-spaced), plus
                  ``sum``/``count`` so rates and means survive export.

Two exporters:

* ``MetricsRegistry.to_jsonl``       — one JSON object per instrument
  line, append-friendly;
* ``MetricsRegistry.to_prometheus``  — the text exposition format
  (``# TYPE``/``# HELP``, ``_bucket{le=...}``/``_sum``/``_count``).

Everything here is host-side and registry-local.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

#: Default histogram buckets for solver-scale wall times, in seconds:
#: log-spaced from 1 us (a cached scalar op) to 100 s (a cold multi-level
#: setup trace), ~4 buckets per decade.
SOLVER_TIME_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 4.0), 12) for e in range(-24, 9))

#: Buckets for iteration-count-like quantities.
ITER_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotone counter.  ``inc`` rejects negative deltas loudly — a
    decreasing counter silently breaks every rate() a dashboard computes."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, labels: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {value})")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + float(value)

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[Tuple, float]:
        return dict(self._values)


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, labels: Optional[dict] = None) -> None:
        self._values[_label_key(labels)] = float(value)

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[Tuple, float]:
        return dict(self._values)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets   # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram:
    """Fixed-bucket histogram (upper bounds + implicit +Inf overflow).

    Stores *non-cumulative* per-bucket counts internally; the Prometheus
    exporter emits the cumulative ``le`` convention.  ``quantile`` gives
    the classic linear-in-bucket estimate — good enough for an SLO line,
    explicitly not an exact order statistic.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = SOLVER_TIME_BUCKETS):
        self.name, self.help = name, help
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        if len(set(bs)) != len(bs):
            raise ValueError(f"duplicate histogram buckets for {name}: {bs}")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._series: Dict[Tuple, _HistSeries] = {}

    def _get(self, labels: Optional[dict]) -> _HistSeries:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1)
        return s

    def observe(self, value: float, labels: Optional[dict] = None) -> None:
        v = float(value)
        s = self._get(labels)
        # first bucket whose upper bound holds v; the trailing slot is +Inf
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        s.counts[lo] += 1
        s.sum += v
        s.count += 1
        s.min = min(s.min, v)
        s.max = max(s.max, v)

    def snapshot(self, labels: Optional[dict] = None) -> dict:
        s = self._get(labels)
        return {"count": s.count, "sum": s.sum,
                "min": None if s.count == 0 else s.min,
                "max": None if s.count == 0 else s.max,
                "buckets": dict(zip(list(self.buckets) + [math.inf],
                                    s.counts))}

    def quantile(self, q: float, labels: Optional[dict] = None) -> float:
        """Linear-in-bucket quantile estimate (NaN on an empty series)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        s = self._get(labels)
        if s.count == 0:
            return math.nan
        rank = q * s.count
        seen = 0.0
        prev_bound = 0.0
        for i, c in enumerate(s.counts):
            if seen + c >= rank and c > 0:
                bound = (self.buckets[i] if i < len(self.buckets)
                         else s.max)
                frac = (rank - seen) / c
                return prev_bound + frac * (bound - prev_bound)
            seen += c
            if i < len(self.buckets):
                prev_bound = self.buckets[i]
        return s.max

    def series(self) -> Dict[Tuple, _HistSeries]:
        return dict(self._series)


def _tensors(out):
    """Every tensor in ``out``: tensors, tuples, lists, dicts and
    dataclass or NamedTuple fields, walked recursively."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def block_ready(out):
    """Wait until every CUDA tensor in ``out`` is computed: synchronise
    each CUDA device they lie on (kernels run asynchronously, so a span
    that does not wait times the enqueue).  CPU tensors are ready."""
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


class Timer:
    """Wall-clock span recording into a histogram on exit.

    Use ``block(out)`` on the device results produced inside the span —
    kernels run asynchronously, so the Python line finishes long before
    the device does, and an unblocked span times the *enqueue*.

        with registry.timer("solve_wall") as t:
            res = solve(hier, b)
            t.block(res)
    """

    def __init__(self, hist: Histogram, labels: Optional[dict] = None):
        self._hist = hist
        self._labels = labels
        self.seconds: Optional[float] = None

    def block(self, out):
        return block_ready(out)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        if exc_type is None:
            self._hist.observe(self.seconds, labels=self._labels)


class MetricsRegistry:
    """Process-local named-instrument registry (thread-safe creation).

    One registry per concern (a server owns one, a benchmark run owns
    one).
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._seen_phases: set = set()

    def _make(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, **kw)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._make(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._make(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = SOLVER_TIME_BUCKETS
                  ) -> Histogram:
        return self._make(name, Histogram, help=help, buckets=buckets)

    def timer(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Timer:
        return Timer(self.histogram(name, help=help), labels=labels)

    def instruments(self) -> List[object]:
        with self._lock:
            return list(self._instruments.values())

    def get(self, name: str):
        return self._instruments.get(name)

    # ---- trace/compile vs steady-state ----------------------------------
    def measure(self, name: str, fn, *args, labels: Optional[dict] = None):
        """Run ``fn(*args)`` fully blocked, filing the duration under
        ``{name}/compile`` on the *first* observation of ``name`` (+labels)
        and ``{name}/steady`` afterwards.

        The first call pays first-use costs (the kernel library build,
        cuBLAS/cuSOLVER handles), which can be 1000x the steady-state
        time — folding it into one histogram makes both numbers
        meaningless.  Returns ``fn``'s (blocked) result.
        """
        key = (name, _label_key(labels))
        first = key not in self._seen_phases
        self._seen_phases.add(key)
        suffix = "/compile" if first else "/steady"
        with self.timer(name + suffix, labels=labels) as t:
            out = fn(*args)
            t.block(out)
        return out

    # ---- exporters -------------------------------------------------------
    def to_jsonl(self, fileobj=None, timestamp: Optional[float] = None
                 ) -> str:
        """One JSON object per instrument (per label set), newline-joined.

        Appends to ``fileobj`` when given; always returns the text.
        """
        ts = time.time() if timestamp is None else timestamp
        lines = []
        for inst in self.instruments():
            if isinstance(inst, (Counter, Gauge)):
                for key, val in inst.series().items():
                    lines.append(json.dumps(
                        {"ts": ts, "name": inst.name, "type": inst.kind,
                         "labels": dict(key), "value": val},
                        sort_keys=True))
            else:
                for key in inst.series():
                    snap = inst.snapshot(dict(key))
                    lines.append(json.dumps(
                        {"ts": ts, "name": inst.name, "type": inst.kind,
                         "labels": dict(key), "count": snap["count"],
                         "sum": snap["sum"], "min": snap["min"],
                         "max": snap["max"],
                         "buckets": {str(k): v for k, v
                                     in snap["buckets"].items()}},
                        sort_keys=True))
        text = "\n".join(lines)
        if fileobj is not None and text:
            fileobj.write(text + "\n")
        return text

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        out = []
        for inst in self.instruments():
            name = _prom_name(inst.name)
            if inst.help:
                out.append(f"# HELP {name} {inst.help}")
            out.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, (Counter, Gauge)):
                for key, val in sorted(inst.series().items()):
                    out.append(f"{name}{_label_str(key)} {_fmt(val)}")
            else:
                for key, s in sorted(inst.series().items()):
                    cum = 0
                    for i, bound in enumerate(inst.buckets):
                        cum += s.counts[i]
                        lab = _label_str(key + (("le", _fmt(bound)),))
                        out.append(f"{name}_bucket{lab} {cum}")
                    cum += s.counts[-1]
                    lab = _label_str(key + (("le", "+Inf"),))
                    out.append(f"{name}_bucket{lab} {cum}")
                    out.append(f"{name}_sum{_label_str(key)} {_fmt(s.sum)}")
                    out.append(f"{name}_count{_label_str(key)} {s.count}")
        return "\n".join(out) + "\n"


def _prom_name(name: str) -> str:
    """Metric names here use '/' for phase nesting; Prometheus only
    allows [a-zA-Z0-9_:], so slashes and dashes export as '_'."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)
