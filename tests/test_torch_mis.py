"""The port's device Luby-MIS coarsener against ``repro.core.aggregation``
and ``repro.core.gamg`` (JAX on the CPU): the hash, the MIS, the
aggregates, the undersized-aggregate repair and whole ``coarsener="mis"``
setups, bitwise (every output is an integer), with equal CG iterations."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core.strength import strength_graph as ref_strength  # noqa
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.strength import StrengthGraph, strength_graph  # noqa
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402

#: (m, coarse_size, reference level_rows, reference n_agg per level, CG
#: iterations): the reference's own MIS runs on the CPU
MIS_CASES = [(6, 12, [540, 150, 72], [25, 12], 8),
             (7, 12, [882, 204, 114, 18], [34, 19, 3], 9)]
MIS_IDS = ["m6-cs12", "m7-cs12"]
SPGEMM_FIELDS = ("indptr", "indices", "pair_a", "pair_b", "out_idx",
                 "tile_pair_a", "tile_pair_b", "tile_mask", "tile_seg")


def _port_graph(g) -> StrengthGraph:
    return StrengthGraph(indptr=np.asarray(g.indptr),
                         indices=np.asarray(g.indices),
                         weights=np.asarray(g.weights), n=g.n)


def _random_graph(seed: int, n: int, dens: float):
    """A symmetric random graph as a reference ``StrengthGraph`` and its
    dense adjacency."""
    from repro.core.strength import StrengthGraph as RefGraph
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((n, n)) < dens, 1)
    adj = mask | mask.T
    rows, cols = np.nonzero(adj)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    g = RefGraph(indptr=np.cumsum(indptr), indices=cols.astype(np.int32),
                 weights=rng.random(len(cols)), n=n)
    return g, adj


@pytest.fixture(scope="module", params=[6, 7], ids=["m6", "m7"])
def fine_graph(request):
    """The fine-level strength graph of the host-assembled problem (the
    port's has the reference's edges; the MIS reads no weight)."""
    m = request.param
    g = ref_strength(ref_assemble(m, path="host").A, 0.08)
    pg = strength_graph(assemble_elasticity(m, path="host",
                                            device="cpu").A, 0.08)
    for name in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(pg, name), getattr(g, name))
    return g


@pytest.mark.parametrize("n", [1, 7, 1000, 100_000])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hash_weights_match_reference(n, seed):
    """Bitwise for the seeds whose offset fits uint32; where it does not
    (seeds 2 and 3), both raise."""
    try:
        want = np.asarray(ref_agg._hash_weights(n, seed)).astype(np.int64)
    except OverflowError:
        with pytest.raises(OverflowError):
            agg._hash_weights(n, seed, device="cpu")
        return
    got = agg._hash_weights(n, seed, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_mis_inputs_default_to_cuda_and_raise_without_it(fine_graph):
    """Like every other entry point of the port, the device coarsener's
    inputs go to the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agg.graph_to_ell(_port_graph(fine_graph))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agg._hash_weights(8, 0)


def test_graph_to_ell_matches_reference(fine_graph):
    idx, mask = ref_agg.graph_to_ell(fine_graph)
    pidx, pmask = agg.graph_to_ell(_port_graph(fine_graph), device="cpu")
    assert pidx.dtype == torch.int32 and pmask.dtype == torch.bool
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))


def test_mis_and_aggregates_match_reference_on_the_mesh(fine_graph):
    idx, mask = ref_agg.graph_to_ell(fine_graph)
    pidx, pmask = agg.graph_to_ell(_port_graph(fine_graph), device="cpu")
    np.testing.assert_array_equal(
        agg.luby_mis_device(pidx, pmask).numpy(),
        np.asarray(ref_agg.luby_mis_device(idx, mask)))
    got = agg.mis_aggregate_device(pidx, pmask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_agg.mis_aggregate_device(idx, mask)))
    a, b = agg.aggregation_from_device(got), ref_agg.aggregation_from_device(
        ref_agg.mis_aggregate_device(idx, mask))
    assert a.n_agg == b.n_agg
    np.testing.assert_array_equal(a.node_to_agg, b.node_to_agg)


@pytest.mark.parametrize("seed,n,dens", [(0, 2, 0.5), (1, 17, 0.05),
                                         (2, 40, 0.3), (3, 300, 0.02),
                                         (4, 64, 0.0), (5, 33, 0.9)])
def test_mis_and_aggregates_match_reference_on_random_graphs(seed, n, dens):
    g, _ = _random_graph(seed, n, dens)
    idx, mask = ref_agg.graph_to_ell(g)
    pidx, pmask = agg.graph_to_ell(_port_graph(g), device="cpu")
    np.testing.assert_array_equal(
        agg.luby_mis_device(pidx, pmask).numpy(),
        np.asarray(ref_agg.luby_mis_device(idx, mask)))
    np.testing.assert_array_equal(
        agg.mis_aggregate_device(pidx, pmask).numpy(),
        np.asarray(ref_agg.mis_aggregate_device(idx, mask)))


@given(st.integers(0, 2**31 - 1), st.integers(2, 40),
       st.floats(0.05, 0.5))
@settings(max_examples=20, deadline=None)
def test_luby_mis_independent_and_maximal(seed, n, dens):
    """Device MIS: no two adjacent members; every non-member has one."""
    g, adj = _random_graph(seed, n, dens)
    idx, m = agg.graph_to_ell(_port_graph(g), device="cpu")
    in_mis = agg.luby_mis_device(idx, m).numpy().astype(bool)
    assert not (adj & np.outer(in_mis, in_mis)).any(), "not independent"
    uncovered = ~in_mis & ~(adj @ in_mis.astype(int) > 0)
    assert not uncovered.any(), "not maximal"


@pytest.mark.parametrize("min_size", [1, 2, 3, 5])
def test_repair_small_aggregates_matches_reference(fine_graph, min_size):
    idx, mask = ref_agg.graph_to_ell(fine_graph)
    aggr = ref_agg.aggregation_from_device(
        ref_agg.mis_aggregate_device(idx, mask))
    want = ref_gamg._repair_small_aggregates(aggr, fine_graph, min_size)
    port_in = agg.Aggregation(node_to_agg=aggr.node_to_agg.copy(),
                              n_agg=aggr.n_agg)
    got = gamg._repair_small_aggregates(port_in, _port_graph(fine_graph),
                                        min_size)
    assert got.n_agg == want.n_agg
    np.testing.assert_array_equal(got.node_to_agg, want.node_to_agg)
    np.testing.assert_array_equal(port_in.node_to_agg, aggr.node_to_agg)


def _mis_setups(m, coarse_size):
    rp = ref_assemble(m, path="host")
    ref = ref_gamg.GAMGSolver(rp.A, rp.B, coarse_size=coarse_size,
                              coarsener="mis", rtol=1e-8, maxiter=200)
    pp = assemble_elasticity(m, path="host", device="cpu")
    port = gamg.GAMGSolver(pp.A, pp.B, coarse_size=coarse_size,
                           coarsener="mis")
    return rp, ref, pp, port


@pytest.fixture(scope="module", params=MIS_CASES, ids=MIS_IDS)
def mis_setups(request):
    m, coarse_size, rows, n_agg, iters = request.param
    return _mis_setups(m, coarse_size) + (rows, n_agg, iters)


def test_mis_setup_levels_and_aggregates_match(mis_setups):
    _, ref, _, port, rows, n_agg, _ = mis_setups
    rs, ps = ref.setup_data, port.setup_data
    assert rs.stats["level_rows"] == rows
    assert ps.coarsener == "mis"
    for key in ("level_rows", "level_nnzb", "level_bs"):
        assert ps.stats[key] == rs.stats[key], key
    assert [ls.aggr.n_agg for ls in ps.levels] == n_agg
    assert len(ps.stats["mis_rounds"]) == len(ps.levels)
    for rl, pl in zip(rs.levels, ps.levels):
        assert pl.aggr.n_agg == rl.aggr.n_agg
        np.testing.assert_array_equal(pl.aggr.node_to_agg,
                                      np.asarray(rl.aggr.node_to_agg))


def test_mis_setup_plans_match(mis_setups):
    _, ref, _, port, *_ = mis_setups
    for rl, pl in zip(ref.setup_data.levels, port.setup_data.levels):
        np.testing.assert_array_equal(pl.P.indptr, rl.P.indptr)
        np.testing.assert_array_equal(pl.P.indices, rl.P.indices)
        for plan in ("ap_plan", "ac_plan"):
            for name in SPGEMM_FIELDS:
                np.testing.assert_array_equal(
                    getattr(getattr(pl.ptap_cache, plan), name),
                    getattr(getattr(rl.ptap_cache, plan), name))


def test_mis_setup_iterations_match(mis_setups):
    rp, ref, pp, port, _, _, iters = mis_setups
    for step in range(3):
        ref.update_operator(rp.reassemble(1.0 + 0.1 * step).data)
        port.update_operator(pp.reassemble(1.0 + 0.1 * step).data)
        want, got = ref.solve(rp.b), port.solve(pp.b)
        assert got.iters == int(want.iters) == iters
        assert int(got.health.status) == 0


def test_setup_default_routes_through_device_mis():
    """The default coarsener is the MIS, on the default (device) assembly
    path too: m=6, coarse_size=12 gives the reference's levels."""
    prob = assemble_elasticity(6, device="cpu")
    setupd = gamg.setup(prob.A, prob.B, coarse_size=12)
    assert setupd.coarsener == "mis"
    assert setupd.stats["level_rows"] == MIS_CASES[0][2]
    with pytest.raises(ValueError, match="invalid coarsener"):
        gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="bogus")


def test_mis_greedy_coarsener_parity_and_quality():
    """MIS and greedy both give valid aggregations (full cover, dense
    ids, real coarsening) of comparable rate and solve quality (m=5)."""
    prob = assemble_elasticity(5, device="cpu")
    graph = strength_graph(prob.A, 0.08)
    idx, mask = agg.graph_to_ell(graph, device="cpu")
    mis = agg.aggregation_from_device(agg.mis_aggregate_device(idx, mask))
    greedy = agg.greedy_aggregate(graph, min_size=2)
    for aggr in (mis, greedy):
        assert aggr.node_to_agg.shape == (graph.n,)
        assert set(np.unique(aggr.node_to_agg)) == set(range(aggr.n_agg))
        assert 1 < aggr.n_agg < graph.n
    assert mis.n_agg < 3 * greedy.n_agg and greedy.n_agg < 3 * mis.n_agg
    iters = {}
    for c in ("mis", "greedy"):
        res = gamg.GAMGSolver(prob.A, prob.B, coarse_size=30, coarsener=c,
                              maxiter=120).solve(prob.b)
        assert bool(res.converged), c
        iters[c] = res.iters
    assert abs(iters["mis"] - iters["greedy"]) <= 5, iters


@pytest.mark.slow
def test_mis_setup_m12_matches_reference():
    """Quickstart's setting at m=12 (coarse_size=40): levels
    ``[4752, 1212, 918, 66]``, n_agg ``[202, 153, 11]`` and 9 iterations a
    hot step on both sides (~1 min)."""
    rp, ref, pp, port = _mis_setups(12, 40)
    ps = port.setup_data
    assert ps.stats["level_rows"] == ref.setup_data.stats["level_rows"] \
        == [4752, 1212, 918, 66]
    assert [ls.aggr.n_agg for ls in ps.levels] == [202, 153, 11]
    for rl, pl in zip(ref.setup_data.levels, ps.levels):
        np.testing.assert_array_equal(pl.aggr.node_to_agg,
                                      np.asarray(rl.aggr.node_to_agg))
    for step in range(3):
        ref.update_operator(rp.reassemble(1.0 + 0.1 * step).data)
        port.update_operator(pp.reassemble(1.0 + 0.1 * step).data)
        assert port.solve(pp.b).iters == int(ref.solve(rp.b).iters) == 9


def test_setup_from_numpy_carries_the_coarsener(mis_setups):
    """``interop.setup_from_numpy`` takes the coarsener's name: the
    reference's MIS hierarchy crosses over as an MIS setup."""
    from repro_torch.interop import setup_from_numpy
    from torch_helpers import setup_to_numpy
    levels, coarse = setup_to_numpy(mis_setups[1].setup_data)
    got = setup_from_numpy(levels, coarse, device="cpu")
    assert got.coarsener == "mis"
    assert got.stats["level_rows"] == mis_setups[4]
    for gl, pl in zip(got.levels, mis_setups[3].setup_data.levels):
        np.testing.assert_array_equal(gl.aggr.node_to_agg,
                                      pl.aggr.node_to_agg)
    greedy = setup_from_numpy(levels, coarse, coarsener="greedy",
                              device="cpu")
    assert greedy.coarsener == "greedy"
    with pytest.raises(ValueError, match="invalid coarsener"):
        setup_from_numpy(levels, coarse, coarsener="bogus", device="cpu")
