"""The traced window: ``torch.profiler`` over a few units of work, reduced
to device busy time, the program's own kernel launches, device time under
the program's ``recompute/*`` spans, and the breakdown the result line
carries.

The session opens on a throwaway warm-up whose records are dropped, and
the units keep a host pause from each edge of the recorded window: a
session opened late in a process has lost the first device records of
its window before.  The program's library kernels in the trace are held
to the count of launches the library itself noted across the window
(``kernels.autotune.launch_record``); a trace that misses one is blind,
and its numbers are not used.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from pathlib import Path

from torch.autograd import DeviceType

WARMUP_KERNELS = 16
EDGE_PAUSE_S = 0.02
TOP = 10


def library_kernels(src: Path) -> set:
    """The ``__global__`` kernels the program's CUDA sources define."""
    names = set()
    for f in sorted((src / "repro_torch" / "kernels" / "csrc")
                    .glob("*.cu")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", f.read_text()))
    return names


def kernel_name(event_name: str) -> str:
    """A demangled signature's own name (``void (anonymous
    namespace)::spmv_kernel<3, 3, double>(...)`` -> ``spmv_kernel``)."""
    m = re.search(r"(?:^|[\s:])(\w+)[<(]", event_name)
    return m.group(1) if m else event_name


@dataclasses.dataclass
class Trace:
    window_s: float            # host wall time of the traced units
    busy_s: float              # union of device activity in the window
    recompute_s: float         # device time launched under recompute/*
    device_events: int
    linked_events: int         # device events whose launch was found
    library_events: int
    library_launches: int
    device_ops: list           # [[name, seconds]] top by device time
    idle_gaps: list            # [[host op before the gap, seconds]]

    @property
    def complete(self) -> bool:
        return self.library_events == self.library_launches


def traced(run_units, src: Path):
    """Run ``run_units()`` (which ends synchronised) under the profiler;
    returns the function that reduces the record to a ``Trace``, to be
    called once the measured window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.autotune import launch_record

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        warm = torch.zeros(WARMUP_KERNELS, device="cuda")
        for i in range(WARMUP_KERNELS):
            warm[i:].add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(EDGE_PAUSE_S)
        noted = launch_record()[0]
        t0 = time.perf_counter()
        run_units()
        window_s = time.perf_counter() - t0
        noted = launch_record()[0] - noted
        time.sleep(EDGE_PAUSE_S)
        prof.step()
    events = prof.profiler.kineto_results.events()
    return lambda: reduce(events, window_s, noted, library_kernels(src))


def _union(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``)."""
    return re.match(r"cu(da)?[A-Z]", name) is not None


def reduce(events, window_s: float, launches: int, library: set) -> Trace:
    """Kineto events of one window to its ``Trace``.  Device events are
    the card's kernels, copies and sets (not its annotation ranges)."""
    device, host, launched_by, spans = [], [], {}, []
    for e in events:
        name, note = e.name(), e.is_user_annotation()
        if e.device_type() == DeviceType.CUDA:
            if not note and not name.startswith("ProfilerStep"):
                device.append(e)
        elif not _is_runtime(name):
            # a device event's linked correlation id is the id of the
            # host op or span that was innermost when it was launched
            launched_by[e.correlation_id()] = e.start_ns()
            host.append(e)
            if note and name.startswith("recompute/"):
                spans.append((e.start_ns(), e.end_ns()))
    busy = _union((e.start_ns(), e.end_ns()) for e in device)
    by_name = {}
    for e in device:
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    spans.sort()
    starts = [a for a, _ in spans]
    recompute = linked = 0
    for e in device:
        t = launched_by.get(e.linked_correlation_id())
        if t is None:
            continue
        linked += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            recompute += e.duration_ns()
    lib = sum(1 for e in device if kernel_name(e.name()) in library)
    # idle gaps between device activity, named by the host op or span
    # that started last before the gap's middle
    host.sort(key=lambda e: e.start_ns())
    host_starts = [e.start_ns() for e in host]
    gaps = {}
    edges = sorted((e.start_ns(), e.end_ns()) for e in device)
    end = None
    for a, b in edges:
        if end is not None and a > end:
            i = bisect.bisect_right(host_starts, (a + end) // 2) - 1
            name = host[i].name() if i >= 0 else "(none)"
            gaps[name] = gaps.get(name, 0) + (a - end)
        end = b if end is None else max(end, b)

    def top(d):
        return [[n, v / 1e9] for n, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:TOP]]
    return Trace(window_s=window_s, busy_s=busy / 1e9,
                 recompute_s=recompute / 1e9, device_events=len(device),
                 linked_events=linked, library_events=lib,
                 library_launches=launches, device_ops=top(by_name),
                 idle_gaps=top(gaps))
