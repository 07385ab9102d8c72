"""The lanes map of the port's blocked ELL kernels
(``repro_torch.kernels.ell_rows``) and what the wrappers hand the C entry
points, on the CPU; and the greedy coarsener's tie tracer
(``repro_torch.core.aggregation.trace_tie_flips``).  The kernels
themselves, every lanes value and the C entry's refusal of a bad one are
held on the card by ``tests/test_torch_cuda.py``."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.aggregation import (  # noqa: E402
    greedy_aggregate,
    trace_tie_flips,
)
from repro_torch.core.gamg import GAMGSolver  # noqa: E402
from repro_torch.core.strength import StrengthGraph  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.kernels import autotune, backend, ell_rows  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402

#: the m=32 main path's ELL operators: A0, P0, A1, A2, P2 (ROADMAP.md)
M32 = [(3, 3, 27), (3, 6, 8), (6, 6, 45), (6, 6, 490), (6, 6, 19)]
GRID = [(br, bc, kmax) for br, bc in ((3, 3), (3, 6), (6, 6))
        for kmax in (0, 1, 2, 3, 4, 5, 7, 8, 9, 27, 45, 127, 128, 129, 490,
                     5000)]


@pytest.mark.parametrize("br,bc,kmax", GRID)
def test_lanes_is_a_power_of_two_within_a_warp(br, bc, kmax):
    n = ell_rows.lanes(br, bc, kmax)
    assert isinstance(n, int) and 1 <= n <= 32 and n & (n - 1) == 0
    # the fewest lanes that keep each lane's share of the row's payload
    # within DOUBLES_PER_LANE, short of a warp
    share = ell_rows.DOUBLES_PER_LANE
    assert n == 32 or n * share >= kmax * br * bc
    assert n == 1 or (n // 2) * share < kmax * br * bc


def test_lanes_is_a_function_of_the_shape_alone(monkeypatch):
    assert list(inspect.signature(ell_rows.lanes).parameters) == [
        "br", "bc", "kmax"]
    want = [ell_rows.lanes(*s) for s in GRID]
    for var, val in (("REPRO_TORCH_TUNE", "sweep"),
                     ("REPRO_TORCH_TUNE_CACHE", "/nonexistent/t.json")):
        monkeypatch.setenv(var, val)
    assert [ell_rows.lanes(*s) for s in GRID] == want
    # wide sub-warps for the wide coarse rows, narrow for the fine level
    assert ell_rows.lanes(6, 6, 490) == 32
    assert ell_rows.lanes(6, 6, 45) >= 8
    assert ell_rows.lanes(3, 3, 27) <= 8
    assert ell_rows.lanes(3, 6, 8) <= 4


def test_lanes_is_not_a_knob():
    """The autotuner's families keep the one knob ``threads``."""
    for knobs in autotune.CANDIDATES.values():
        assert set(knobs) == {"threads"}
    with pytest.raises(ValueError):
        ell_rows.lanes(3, 3, -1)


def _launched(monkeypatch, call):
    """Run a wrapper as if its tensors were on the card, capturing the C
    entry point's arguments instead of launching."""
    seen = []
    for mod in (spmv_ops, spmm_ops):
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(backend, "on_cuda", lambda name, **t: True)
    monkeypatch.setattr(backend, "launch",
                        lambda name, argtypes, *args: seen.append(
                            (name, len(argtypes), args)))
    call()
    (name, nargs, args), = seen
    # every argument but the stream, which ``launch`` appends
    assert nargs == len(args) + 1
    return name, args


@pytest.mark.parametrize("br,bc,kmax", M32 + [(3, 3, 1), (6, 6, 3)])
@pytest.mark.parametrize("threads", [32, 256, 512])
def test_both_wrappers_pass_the_same_lanes(monkeypatch, br, bc, kmax,
                                           threads):
    rng = np.random.default_rng(br * 100 + kmax)
    nbr, nbc, k = 5, 4, 3
    idx = torch.as_tensor(rng.integers(0, nbc, (nbr, kmax)),
                          dtype=torch.int32)
    data = torch.as_tensor(rng.standard_normal((nbr, kmax, br, bc)))
    x = torch.as_tensor(rng.standard_normal((nbc, bc)))
    X = torch.as_tensor(rng.standard_normal((nbc, bc, k)))
    want = ell_rows.lanes(br, bc, kmax)
    calls = []
    orig = ell_rows.lanes

    def spy(*a):
        calls.append(a)
        return orig(*a)
    monkeypatch.setattr(ell_rows, "lanes", spy)
    name, args = _launched(monkeypatch, lambda: spmv_ops.block_spmv_ell(
        idx, data, x, threads=threads))
    assert name == "repro_block_spmv_f64"
    assert args[4:] == (nbr, kmax, br, bc, want, threads)
    name, args = _launched(monkeypatch, lambda: spmm_ops.block_spmm_ell(
        idx, data, X, threads=threads))
    assert name == "repro_block_spmm_f64"
    assert args[4:] == (nbr, kmax, br, bc, k, want, threads)
    assert calls == [(br, bc, kmax)] * 2


@pytest.mark.parametrize("bc", [3, 6])
def test_misaligned_even_width_payloads_raise(monkeypatch, bc):
    """Even-width blocks are read in 16-byte pairs: a payload view 8 bytes
    off an allocation is refused before the launch; odd widths pass."""
    nbr, kmax, br = 4, 3, 3
    flat = torch.zeros(1 + nbr * kmax * br * bc, dtype=torch.float64)
    data = flat[1:].view(nbr, kmax, br, bc)
    assert data.is_contiguous() and data.data_ptr() % 16 == 8
    idx = torch.zeros((nbr, kmax), dtype=torch.int32)
    x, X = (torch.zeros(shape, dtype=torch.float64)
            for shape in ((2, bc), (2, bc, 3)))
    calls = (lambda: spmv_ops.block_spmv_ell(idx, data, x),
             lambda: spmm_ops.block_spmm_ell(idx, data, X))
    for call in calls:
        if bc % 2:
            _launched(monkeypatch, call)
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _launched(monkeypatch, call)


def _graph(n, edges):
    """A symmetric StrengthGraph from ``{(i, j): weight}``."""
    rows, cols, w = [], [], []
    for (i, j), v in sorted(edges.items()):
        rows += [i, j]
        cols += [j, i]
        w += [v, v]
    order = np.lexsort((cols, rows))
    rows, cols, w = (np.asarray(a)[order] for a in (rows, cols, w))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return StrengthGraph(indptr=np.cumsum(indptr), indices=cols,
                         weights=w.astype(np.float64), n=n)


def _tied_graph(w2=0.7, w4=0.7):
    """Two aggregates {0,1,2} and {3,4,5} from pass 1; node 6 hangs off
    nodes 2 and 4 with weights ``w2`` and ``w4``, so pass 2 decides
    between them (on a tie by default)."""
    return _graph(7, {(0, 1): 1.0, (0, 2): 1.0, (3, 4): 1.0, (3, 5): 1.0,
                      (2, 6): w2, (4, 6): w4})


def test_a_tie_flipped_by_an_ulp_is_traced():
    ga, gb = _tied_graph(), _tied_graph(w4=np.nextafter(0.7, 1.0))
    a, b = greedy_aggregate(ga, 2), greedy_aggregate(gb, 2)
    assert a.node_to_agg[6] == a.node_to_agg[2]
    assert b.node_to_agg[6] == b.node_to_agg[4]
    out = trace_tie_flips(ga, gb, 2, tie_rtol=4 * np.finfo(float).eps)
    assert out == dict(same_edges=True, differing_nodes=1, flips=1,
                       max_tie_gap=0.0, traced=True)
    # judged by gb's weights the gap is one ulp
    back = trace_tie_flips(gb, ga, 2, tie_rtol=4 * np.finfo(float).eps)
    assert back["traced"] and 0 < back["max_tie_gap"] < 2e-16


def test_a_difference_beyond_the_tolerance_is_not_traced():
    ga, gb = _tied_graph(w4=0.9), _tied_graph(w2=0.9)
    out = trace_tie_flips(ga, gb, 2, tie_rtol=1e-15)
    assert out["differing_nodes"] == 1 and out["flips"] == 0
    assert not out["traced"]
    assert trace_tie_flips(ga, gb, 2, tie_rtol=0.3)["traced"]
    # other edges: not comparable at all
    gc = _graph(7, {(0, 1): 1.0, (0, 2): 1.0, (3, 4): 1.0, (3, 5): 1.0,
                    (2, 6): 0.7})
    out = trace_tie_flips(ga, gc, 2, tie_rtol=1.0)
    assert not out["same_edges"] and not out["traced"]


def test_the_setup_agrees_with_itself_through_the_tracer():
    """On every level of a real hierarchy the tracer reproduces the
    setup's own aggregates with no flip."""
    from repro_torch.core.strength import strength_graph
    prob = assemble_elasticity(7, path="host", device="cpu")
    s = GAMGSolver(prob.A, prob.B, coarse_size=12,
                   coarsener="greedy").setup_data
    for ls in s.levels:
        g = strength_graph(ls.A0, s.theta)
        min_size = -(-s.nns_dim // ls.A0.br)
        np.testing.assert_array_equal(
            greedy_aggregate(g, min_size).node_to_agg, ls.aggr.node_to_agg)
        assert trace_tie_flips(g, g, min_size, 0.0) == dict(
            same_edges=True, differing_nodes=0, flips=0, max_tie_gap=0.0,
            traced=True)
