"""The program's host ranges in one traced window: what the host was doing
while the card idled, the device time launched under each family of
ranges, the host syncs, and the blocking calls outside them.

    python3 amgbench/spans.py --workload <name> --seeds 1 2 3 \
        --seconds <s>

runs the cell as ``run.py --trace 1`` does, once a seed, and prints one
JSON line a seed: the result's metrics, the traced window's wall time a
unit, the readings of ``readings`` a unit, the reduction ``reduce_spans``
of the window's events, and ``blocking_calls``.  Needs a CUDA device.

Ranges are the program's ``record_function`` ranges (``ProfilerStep#``
aside).  A device event was launched inside a range when the host op that
launched it started inside the range (``tracing.reduce``'s rule for
``recompute_s``).  An idle gap lies between two device events; each
instant of it goes to the innermost range open on the host then, or to
``OUTSIDE``.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("assemble/", "recompute/", "server/", "sync/")
OUTSIDE = "(outside any range)"
#: host ranges, a traced unit, that ``server_host_ms`` sums
SERVER_HOST = ("server/submit", "server/flush/pack", "server/flush/report")
#: the server range whose idle time is the solve's own, not the server's
SERVER_SOLVE = "server/flush/solve"
#: blocking CUDA runtime calls (``cudaMemcpyAsync`` is not one); a
#: device-to-host copy blocks too
BLOCKING = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy"}
#: ranges a blocking call of the program may lie in
ALLOWED = ("sync/", "server/flush/fetch")
OP_LOOKBACK = 256


@dataclasses.dataclass
class SpanTrace:
    spans: dict          # range name -> [count, host seconds]
    device_under: dict   # family -> device seconds launched inside it
    idle_in: dict        # innermost range (or OUTSIDE) -> idle seconds
    sync_idle_s: float   # gaps opening inside a sync/* range, whole
    idle_s: float        # every gap between device events


def _split(events):
    """(device events, host ops and ranges, runtime calls, ranges as
    (start, end, name)), with ``tracing.reduce``'s filters."""
    from amgbench.tracing import _is_runtime
    device, host, runtime, ranges = [], [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and \
                    not name.startswith("ProfilerStep"):
                device.append(e)
        elif _is_runtime(name):
            runtime.append(e)
        else:
            host.append(e)
            if e.is_user_annotation() and \
                    not name.startswith("ProfilerStep"):
                ranges.append((e.start_ns(), e.end_ns(), name))
    return device, host, runtime, ranges


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(merged, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def innermost(ranges) -> list:
    """``(start, end, name)`` ranges -> disjoint ``(start, end, name)``
    segments naming the innermost open range: the open one that started
    last (the longer first on a tie)."""
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    points = sorted({p for r in rs for p in r[:2]})
    segs, stack, i = [], [], 0
    for p, q in zip(points, points[1:]):
        while i < len(rs) and rs[i][0] <= p:
            stack.append(rs[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        if stack:
            segs.append((p, q, stack[-1][2]))
    return segs


def _gaps(device) -> list:
    """Idle ``(start, end)`` gaps between device events, as
    ``tracing.reduce`` finds them."""
    gaps, end = [], None
    for a, b in sorted((e.start_ns(), e.end_ns()) for e in device):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def reduce_spans(events) -> SpanTrace:
    """Kineto events of one window to its ``SpanTrace``."""
    device, host, _, ranges = _split(events)
    spans = {}
    for a, b, name in ranges:
        c = spans.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e9
    launched_by = {e.correlation_id(): e.start_ns() for e in host}
    device_under = {}
    for fam in FAMILIES:
        merged = _merged((a, b) for a, b, n in ranges if n.startswith(fam))
        starts = [a for a, _ in merged]
        device_under[fam] = sum(
            e.duration_ns() for e in device
            if (t := launched_by.get(e.linked_correlation_id())) is not None
            and _inside(merged, starts, t)) / 1e9
    segs = innermost(ranges)
    seg_starts = [s for s, _, _ in segs]
    sync = _merged((a, b) for a, b, n in ranges if n.startswith("sync/"))
    sync_starts = [a for a, _ in sync]
    idle, sync_idle, total = collections.Counter(), 0, 0
    for a, b in _gaps(device):
        total += b - a
        if _inside(sync, sync_starts, a):
            sync_idle += b - a
        covered = 0
        i = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(segs[i][0], a), min(segs[i][1], b)
            if hi > lo:
                idle[segs[i][2]] += hi - lo
                covered += hi - lo
            i += 1
        idle[OUTSIDE] += b - a - covered
    return SpanTrace(spans=spans, device_under=device_under,
                     idle_in={n: v / 1e9 for n, v in idle.items() if v},
                     sync_idle_s=sync_idle / 1e9, idle_s=total / 1e9)


def readings(st: SpanTrace, units: int) -> dict:
    """The per-unit numbers of the ranges, each None where the window has
    no range to read it from."""
    def family(prefix):
        return [n for n in st.spans if n.startswith(prefix)]

    syncs, server = family("sync/"), family("server/")
    per = 1e3 / units
    return {
        "assembly_device_ms": per * st.device_under["assemble/"]
        if family("assemble/") else None,
        "host_syncs": sum(st.spans[n][0] for n in syncs) / units
        if syncs else None,
        "sync_idle_ms": per * st.sync_idle_s if syncs else None,
        "server_host_ms": per * sum(st.spans.get(n, (0, 0.0))[1]
                                    for n in SERVER_HOST)
        if server else None,
        "server_idle_ms": per * sum(v for n, v in st.idle_in.items()
                                    if n.startswith("server/")
                                    and n != SERVER_SOLVE)
        if server else None,
    }


def blocking_calls(events) -> dict:
    """Blocking CUDA runtime calls and device-to-host copies of the window,
    counted by ``"<call> | <innermost range> | <host op>"``: the range
    and the op open on the host when the call was made (a copy: when the
    op that issued it started)."""
    device, host, runtime, ranges = _split(events)
    segs = innermost(ranges)
    seg_starts = [s for s, _, _ in segs]
    ops = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if not e.is_user_annotation())
    op_starts = [a for a, _, _ in ops]

    def range_at(t):
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else OUTSIDE

    def op_at(t):
        # the op open at t that started last, looked for among the
        # OP_LOOKBACK ops that started before it
        i = bisect.bisect_right(op_starts, t) - 1
        for j in range(i, max(i - OP_LOOKBACK, -1), -1):
            if ops[j][1] >= t:
                return ops[j][2]
        return "-"

    launched_by = {e.correlation_id(): e.start_ns() for e in host}
    calls = [(e.name(), e.start_ns()) for e in runtime
             if e.name() in BLOCKING]
    calls += [("Memcpy DtoH", launched_by[e.linked_correlation_id()])
              for e in device if e.name().startswith("Memcpy DtoH")
              and e.linked_correlation_id() in launched_by]
    out = collections.Counter(f"{name} | {range_at(t)} | {op_at(t)}"
                              for name, t in calls)
    return dict(sorted(out.items()))


def outside(calls: dict) -> int:
    """Blocking calls outside the ranges allowed for them, the harness's
    own ``torch.cuda.synchronize`` (``cudaDeviceSynchronize``) aside."""
    return sum(n for k, n in calls.items()
               if not k.startswith("cudaDeviceSynchronize")
               and not k.split(" | ")[1].startswith(ALLOWED))


def run(workload, seed, seconds, root=ROOT) -> dict:
    """One traced run of ``workload``; its line."""
    from amgbench import harness, tracing
    cell = harness.load_cell(root, workload)
    harness.prepare_env(cell, trace=True)
    seen = []
    reduce = tracing.reduce

    def keep(events, *args):
        tr = reduce(events, *args)
        seen.append((tr, reduce_spans(events), blocking_calls(events)))
        return tr

    tracing.reduce = keep
    try:
        out = harness.run_cell(cell, seed, seconds, True, time.perf_counter(),
                               src=root / "src")
    finally:
        tracing.reduce = reduce
    tr, st, calls = seen[-1]
    units = cell.traffic["traced_units"]
    return {"workload": workload, "seed": seed, "correct": out["correct"],
            "complete": tr.complete, "metrics": {
                n: m["value"] for n, m in out["metrics"].items()},
            "unit_wall_ms": 1e3 * tr.window_s / units,
            "readings": readings(st, units) if tr.complete else None,
            "idle_ms": 1e3 * st.idle_s / units,
            "idle_by_span_ms": {n: 1e3 * v / units for n, v in sorted(
                st.idle_in.items(), key=lambda kv: -kv[1])},
            "device_under_ms": {f: 1e3 * v / units
                                for f, v in st.device_under.items()},
            "spans": {n: [c / units, 1e3 * s / units]
                      for n, (c, s) in sorted(st.spans.items())
                      if not n.startswith(("kernels/", "vcycle/"))},
            "blocking_calls": calls, "outside": outside(calls)}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in a.seeds:
        print(json.dumps(run(a.workload, seed, a.seconds)), flush=True)


if __name__ == "__main__":
    main()
