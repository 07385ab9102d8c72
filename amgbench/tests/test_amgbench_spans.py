"""The traced window's reductions on hand-made events: ``tracing.reduce``'s
fields pinned, and ``spans.reduce_spans`` / ``readings`` /
``blocking_calls`` on a window with a sync range a gap opens inside,
server ranges over a gap and an ``assemble/`` launch."""
import json
import subprocess
import sys

import pytest
from torch.autograd import DeviceType

from amgbench_cells import ROOT
from amgbench import spans, tracing

NS = 1e-9


class Ev:
    """The part of a kineto event the reductions read."""

    def __init__(self, name, start, end, *, device=False, note=False,
                 corr=0, linked=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._note = device, note
        self._corr, self._linked = corr, linked

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._note

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def _range(name, a, b):
    return Ev(name, a, b, note=True)


def _op(name, a, b, corr):
    return Ev(name, a, b, corr=corr)


def _dev(name, a, b, linked):
    return Ev(name, a, b, device=True, linked=linked)


RANGES = [
    _range("ProfilerStep#1", 0, 1000),
    _range("assemble/value_stream", 10, 40),
    _range("recompute/level0/ptap", 50, 95),
    _range("sync/cg_exit", 100, 200),
    _range("server/flush", 210, 500),
    _range("server/flush/pack", 210, 260),
    _range("server/flush/upload", 260, 300),
    _range("sync/panel_upload", 262, 298),
    _range("server/flush/solve", 300, 400),
    _range("server/flush/report", 420, 480),
    _range("server/submit", 600, 620),
]
OPS = [
    _op("aten::mm", 12, 20, 1),
    _op("aten::spmv", 55, 60, 2),
    _op("aten::_local_scalar_dense", 105, 195, 3),
    _op("aten::copy_", 265, 295, 4),
    _op("aten::smooth", 310, 320, 5),
    _op("aten::add", 700, 710, 6),
]
RUNTIME = [
    _op("cudaLaunchKernel", 13, 15, 100),
    _op("cudaStreamSynchronize", 112, 194, 101),
    _op("cudaStreamSynchronize", 702, 704, 102),
    _op("cudaDeviceSynchronize", 900, 910, 103),
    _op("cudaMemcpyAsync", 305, 306, 104),
]
DEVICE = [
    _dev("sm90_xmma_gemm_f64f64", 30, 60, 1),
    _dev("void (anonymous namespace)::spmv_kernel<3, 3, double>(int)",
         70, 100, 2),
    _dev("Memcpy DtoH (Device -> Pageable)", 110, 120, 3),
    _dev("Memcpy HtoD (Pageable -> Device)", 270, 290, 4),
    _dev("void (anonymous namespace)::smoother_kernel<6, 4>(int)",
         330, 380, 5),
    _dev("add_kernel", 720, 730, 6),
    Ev("gpu range", 0, 1000, device=True, note=True),
]
EVENTS = RANGES + OPS + RUNTIME + DEVICE
LIBRARY = {"spmv_kernel", "smoother_kernel"}


def test_reduce_keeps_its_fields():
    """``tracing.reduce``'s fields on these events, as the parent's
    ``reduce`` gives them."""
    tr = tracing.reduce(EVENTS, 2.5, 2, LIBRARY)
    assert tr.window_s == 2.5
    assert (tr.busy_s, tr.recompute_s) == (150 / 1e9, 30 / 1e9)
    assert (tr.device_events, tr.linked_events, tr.library_events,
            tr.library_launches, tr.complete) == (6, 6, 2, 2, True)
    assert [n for n, _ in tr.device_ops] == [
        DEVICE[4].name(), DEVICE[0].name(), DEVICE[1].name(),
        DEVICE[3].name(), DEVICE[2].name(), DEVICE[5].name()]
    assert [v / NS for _, v in tr.device_ops] == pytest.approx(
        [50, 30, 30, 20, 10, 10])
    assert [n for n, _ in tr.idle_gaps] == [
        "server/flush/report", "aten::_local_scalar_dense", "aten::smooth",
        "aten::spmv"]
    assert [v / NS for _, v in tr.idle_gaps] == pytest.approx(
        [340, 160, 40, 10])


def test_reduce_spans_fields():
    st = spans.reduce_spans(EVENTS)
    assert {n: c for n, (c, _) in st.spans.items()} == dict.fromkeys(
        [r.name() for r in RANGES[1:]], 1)
    assert {n: s / NS for n, (_, s) in st.spans.items()} == pytest.approx({
        "assemble/value_stream": 30, "recompute/level0/ptap": 45,
        "sync/cg_exit": 100, "server/flush": 290, "server/flush/pack": 50,
        "server/flush/upload": 40, "sync/panel_upload": 36,
        "server/flush/solve": 100, "server/flush/report": 60,
        "server/submit": 20})
    assert {f: v / NS for f, v in st.device_under.items()} == \
        pytest.approx({"assemble/": 30, "recompute/": 30, "server/": 70,
                       "sync/": 30})
    # the recompute rule is reduce's
    assert st.device_under["recompute/"] == \
        tracing.reduce(EVENTS, 1.0, 2, LIBRARY).recompute_s
    assert {n: v / NS for n, v in st.idle_in.items()} == pytest.approx({
        "recompute/level0/ptap": 10, "sync/cg_exit": 90,
        spans.OUTSIDE: 210, "server/flush/pack": 50,
        "server/flush/upload": 4, "sync/panel_upload": 16,
        "server/flush/solve": 50, "server/flush": 40,
        "server/flush/report": 60, "server/submit": 20})
    assert st.idle_s / NS == pytest.approx(550)
    assert sum(st.idle_in.values()) == pytest.approx(st.idle_s)
    # gaps opening at 100, 120 and 290 lie in sync ranges; 60 and 380 not
    assert st.sync_idle_s / NS == pytest.approx(200)


def test_readings_a_unit():
    got = spans.readings(spans.reduce_spans(EVENTS), 2)
    assert got == pytest.approx({
        "assembly_device_ms": 1e3 * 15 * NS, "host_syncs": 1.0,
        "sync_idle_ms": 1e3 * 100 * NS,
        "server_host_ms": 1e3 * 65 * NS,
        "server_idle_ms": 1e3 * 87 * NS})


def test_readings_without_the_ranges():
    """A window of the program before these ranges existed (or with
    none recorded) reads nothing; the existing fields are unmoved."""
    bare = [e for e in EVENTS if not e.is_user_annotation()
            or e.name().startswith(("ProfilerStep", "recompute/"))]
    st = spans.reduce_spans(bare)
    assert set(spans.readings(st, 3).values()) == {None}
    assert st.device_under["recompute/"] == pytest.approx(30 * NS)
    assert sum(st.idle_in.values()) == pytest.approx(st.idle_s)
    assert spans.readings(spans.reduce_spans(OPS + DEVICE), 3) == \
        dict.fromkeys(spans.readings(st, 3))


def test_innermost_segments():
    segs = spans.innermost([(0, 10, "a"), (2, 5, "b"), (3, 8, "c"),
                            (12, 14, "d")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 5, "c"), (5, 8, "c"),
                    (8, 10, "a"), (12, 14, "d")]


def test_blocking_calls():
    calls = spans.blocking_calls(EVENTS)
    assert calls == {
        "Memcpy DtoH | sync/cg_exit | aten::_local_scalar_dense": 1,
        "cudaDeviceSynchronize | (outside any range) | -": 1,
        "cudaStreamSynchronize | (outside any range) | aten::add": 1,
        "cudaStreamSynchronize | sync/cg_exit | aten::_local_scalar_dense":
            1}
    assert spans.outside(calls) == 1


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_spans_of_a_served_cell_on_the_card(card):
    """Every blocking call of a traced ``m32.serve`` window lies in a sync
    or fetch range, and every serve reading reads."""
    p = subprocess.run(
        [sys.executable, "amgbench/spans.py", "--workload", "m32.serve",
         "--seeds", "2147483659", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["complete"]
    assert line["outside"] == 0, line["blocking_calls"]
    got = line["readings"]
    assert got["assembly_device_ms"] is None
    assert all(got[k] > 0 for k in ("host_syncs", "sync_idle_ms",
                                    "server_host_ms", "server_idle_ms"))
