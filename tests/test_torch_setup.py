"""The port's cold GAMG setup against ``repro.core.gamg.setup`` (greedy
coarsener): level sizes, aggregates and every plan bitwise, prolongators
and coarse operators to 1e-12 relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.core import gamg  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import setup_from_numpy  # noqa: E402

from torch_helpers import CASE_IDS, CASES, assert_close, \
    setup_to_numpy  # noqa: E402

SPGEMM_FIELDS = ("indptr", "indices", "pair_a", "pair_b", "out_idx",
                 "tile_pair_a", "tile_pair_b", "tile_mask", "tile_seg")


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def setups(request):
    m, coarse_size, rows, _ = request.param
    rp = ref_assemble(m, path="host")
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=coarse_size,
                         coarsener="greedy")
    pp = assemble_elasticity(m, path="host", device="cpu")
    port = gamg.setup(pp.A, pp.B, coarse_size=coarse_size,
                      coarsener="greedy")
    return ref, port, rows


def test_level_sizes_match(setups):
    ref, port, rows = setups
    assert ref.stats["level_rows"] == rows
    for key in ("level_rows", "level_nnzb", "level_bs"):
        assert port.stats[key] == ref.stats[key], key
    assert port.n_levels == ref.n_levels


def test_aggregates_are_bitwise(setups):
    ref, port, _ = setups
    for rl, pl in zip(ref.levels, port.levels):
        np.testing.assert_array_equal(pl.aggr.node_to_agg,
                                      rl.aggr.node_to_agg)
        assert pl.aggr.n_agg == rl.aggr.n_agg
        assert (pl.n_fine, pl.n_coarse) == (rl.n_fine, rl.n_coarse)


def test_prolongators_and_operators_match(setups):
    ref, port, _ = setups
    for rl, pl in zip(ref.levels, port.levels):
        for name in ("A0", "P"):
            r, p = getattr(rl, name), getattr(pl, name)
            np.testing.assert_array_equal(p.indptr, r.indptr)
            np.testing.assert_array_equal(p.indices, r.indices)
            assert_close(p.data, r.data)
        assert_close(pl.omega, rl.omega)
    assert_close(port.coarse_struct.data, ref.coarse_struct.data)
    np.testing.assert_array_equal(port.coarse_struct.indices,
                                  ref.coarse_struct.indices)


def test_plans_are_bitwise(setups):
    ref, port, _ = setups
    for rl, pl in zip(ref.levels, port.levels):
        rc, pc = rl.ptap_cache, pl.ptap_cache
        for name in ("r_indptr", "r_indices", "r_perm"):
            np.testing.assert_array_equal(getattr(pc, name),
                                          getattr(rc, name))
        for plan in ("ap_plan", "ac_plan"):
            rp, pp = getattr(rc, plan), getattr(pc, plan)
            for name in SPGEMM_FIELDS:
                np.testing.assert_array_equal(getattr(pp, name),
                                              getattr(rp, name))
            assert pp.tile_identity == rp.tile_identity
        for name in ("indices", "gather", "mask"):
            np.testing.assert_array_equal(getattr(pl.a_ell_plan, name),
                                          getattr(rl.a_ell_plan, name))
        for name in ("rows", "gather", "mask"):
            np.testing.assert_array_equal(getattr(pl.pt, name),
                                          np.asarray(getattr(rl.pt, name)))
        np.testing.assert_array_equal(pl.p_ell.indices.numpy(),
                                      np.asarray(rl.p_ell.indices))
        assert_close(pl.p_ell.data, rl.p_ell.data)


def test_row_splits_are_exercised(setups):
    """Every case runs at least one product through the seg-sum combine."""
    _, port, _ = setups
    assert any(not getattr(ls.ptap_cache, p).tile_identity
               for ls in port.levels for p in ("ap_plan", "ac_plan"))


def test_setup_from_numpy_rebuilds_the_plans(setups):
    ref, port, _ = setups
    levels, coarse = setup_to_numpy(ref)
    got = setup_from_numpy(levels, coarse, coarsener="greedy",
                           device="cpu")
    assert got.stats["level_rows"] == port.stats["level_rows"]
    for gl, pl in zip(got.levels, port.levels):
        for name in SPGEMM_FIELDS:
            np.testing.assert_array_equal(
                getattr(gl.ptap_cache.ac_plan, name),
                getattr(pl.ptap_cache.ac_plan, name))
        np.testing.assert_array_equal(gl.pt.gather, pl.pt.gather)


def test_unported_options_raise():
    """A bogus restriction mode, coarsener and precision raise;
    ``restriction="stored"`` builds ``R`` / ``r_ell``; ``precision="f32"``
    builds an f32 hierarchy."""
    A = assemble_elasticity(3, device="cpu")
    with pytest.raises(ValueError, match="invalid coarsener"):
        gamg.setup(A.A, A.B, coarsener="bogus")
    with pytest.raises(ValueError, match="invalid precision"):
        gamg.setup(A.A, A.B, precision="f16")
    with pytest.raises(ValueError, match="invalid restriction mode"):
        gamg.setup(A.A, A.B, restriction="bogus")
    st = gamg.setup(A.A, A.B, restriction="stored", coarse_size=12,
                    coarsener="greedy")
    assert st.levels and all(
        ls.R is not None and ls.pt is None
        and ls.r_ell.data.shape[2:] == (ls.P.bc, ls.P.br)
        for ls in st.levels)
    assert all(lv.r_ell is not None
               for lv in gamg.recompute(st, A.A.data).levels)
    s = gamg.setup(A.A, A.B, precision="f32", coarse_size=12,
                   coarsener="greedy")
    hier = gamg.recompute(s, A.A.data)
    assert s.precision.hierarchy_dtype == torch.float32
    assert all(lv.a_ell.data.dtype == torch.float32 for lv in hier.levels)
    assert hier.coarse_chol.dtype == torch.float32


def test_block_containers_match():
    """``to_dense``, ``transpose_bcsr``, ``diagonal_blocks`` and the ELL
    build against the reference containers on random rectangular
    blocks."""
    from repro.core.block_csr import transpose_bcsr as ref_transpose
    from repro_torch.core.block_csr import transpose_bcsr
    from repro_torch.interop import bcsr_from_numpy

    from helpers import random_bcsr
    from torch_helpers import bcsr_dict
    rng = np.random.default_rng(5)
    for br, bc, square in ((3, 6, False), (6, 6, True)):
        A = random_bcsr(rng, 9, 9 if square else 7, br, bc, density=0.4,
                        ensure_diag=square)
        tA = bcsr_from_numpy(**bcsr_dict(A), device="cpu")
        np.testing.assert_array_equal(tA.to_dense().numpy(),
                                      np.asarray(A.to_dense()))
        rT, tT = ref_transpose(A), transpose_bcsr(tA)
        np.testing.assert_array_equal(tT.indptr, rT.indptr)
        np.testing.assert_array_equal(tT.indices, rT.indices)
        np.testing.assert_array_equal(tT.data.numpy(), np.asarray(rT.data))
        np.testing.assert_array_equal(tA.to_ell().data.numpy(),
                                      np.asarray(A.to_ell().data))
        if square:
            np.testing.assert_array_equal(tA.diagonal_blocks().numpy(),
                                          np.asarray(A.diagonal_blocks()))


#: pass-2 ties the m=32 check lets flip: gaps up to this many ulps of the
#: reference's strongest weight (measured: at most 3.7)
TIE_ULPS = 8


@pytest.mark.slow
def test_m32_aggregates_match_the_reference_up_to_traced_ties():
    """The paper's configuration, ``ElasticityConfig(m=32)``, greedy with
    ``coarse_size=100`` (~45 s, ~7 GB for the reference).  Levels, nnzb,
    ``n_agg`` and the level 0-1 aggregates bitwise; from level 2 on the
    two operators differ by rounding, and every node in another aggregate
    must trace back to pass-2 ties within ``TIE_ULPS`` of the reference's
    weights (cascades through later attachments and the undersized-
    aggregate repair included)."""
    from repro.core.strength import strength_graph as ref_strength
    from repro_torch.core.aggregation import greedy_aggregate, \
        trace_tie_flips
    from repro_torch.core.strength import strength_graph
    rp = ref_assemble(32, path="host")
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=100, coarsener="greedy")
    pp = assemble_elasticity(32, path="host", device="cpu")
    port = gamg.setup(pp.A, pp.B, coarse_size=100, coarsener="greedy")
    assert ref.stats["level_rows"] == [95232, 7986, 5016, 114]
    for key in ("level_rows", "level_nnzb", "level_bs"):
        assert port.stats[key] == ref.stats[key], key
    traced = []
    for li, (rl, pl) in enumerate(zip(ref.levels, port.levels)):
        assert pl.aggr.n_agg == rl.aggr.n_agg, li
        if li < 2:
            np.testing.assert_array_equal(pl.aggr.node_to_agg,
                                          rl.aggr.node_to_agg)
            continue
        ga = ref_strength(rl.A0, ref.theta)
        gb = strength_graph(pl.A0, port.theta)
        min_size = -(-port.nns_dim // pl.A0.br)
        # each package's covering is the greedy run on its own graph
        np.testing.assert_array_equal(
            greedy_aggregate(ga, min_size).node_to_agg, rl.aggr.node_to_agg)
        np.testing.assert_array_equal(
            greedy_aggregate(gb, min_size).node_to_agg, pl.aggr.node_to_agg)
        out = trace_tie_flips(ga, gb, min_size,
                              TIE_ULPS * np.finfo(np.float64).eps)
        assert out["same_edges"] and out["traced"], (li, out)
        traced.append(out)
    print("m=32 level 2+ aggregates:", traced)
