"""The port's core front doors against ``repro``'s: twins of
``tests/test_block_core.py`` (its scalar-CSR case waits for the scalar
baseline) and of the spgemm / ``block_axpy`` cases of
``tests/test_property.py`` (fixed seeds in place of hypothesis), the
other module-level names the reference defines, and the torch quickstart
at m=4 against the reference's levels and iterations.  Operands are made
once in numpy and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import block_coo as rcoo  # noqa: E402
from repro.core import gamg as rgamg  # noqa: E402
from repro.core import ptap as rptap  # noqa: E402
from repro.core import spgemm as rspgemm  # noqa: E402
from repro.core import spmv as rspmv  # noqa: E402
from repro.core.block_csr import BlockCSR as RBlockCSR  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.fem.hex_elasticity import \
    nnz_per_row_estimate as ref_nnz_estimate  # noqa: E402
from repro.obs.metrics import \
    parse_prometheus as ref_parse_prometheus  # noqa: E402

from repro_torch import quickstart  # noqa: E402
from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.block_coo import preallocate_coo, \
    scalar_coo_plan_bytes, set_values_coo  # noqa: E402
from repro_torch.core.block_csr import BlockCSR, identity_bcsr, \
    transpose_bcsr  # noqa: E402
from repro_torch.core.ptap import galerkin_flops, ptap, ptap_numeric, \
    ptap_symbolic  # noqa: E402
from repro_torch.core.smooth import invert_diag_blocks, \
    resmooth_prolongator_data, scale_rows_data, \
    smoothed_prolongator  # noqa: E402
from repro_torch.core.spgemm import block_axpy, spgemm, spgemm_numeric, \
    spgemm_symbolic  # noqa: E402
from repro_torch.core.spmv import block_diag_apply, residual, spmv, \
    spmv_bcsr_ref, spmv_csr_ref, spmv_ell  # noqa: E402
from repro_torch.core.tentative import tentative_prolongator  # noqa: E402
from repro_torch.core.vcycle import fine_operator, \
    vcycle_apply_op  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.fem.hex_elasticity import nnz_per_row_estimate  # noqa
from repro_torch.obs.metrics import MetricsRegistry, default_registry, \
    parse_prometheus, reset_default_registry  # noqa: E402

from torch_helpers import assert_close, to_np  # noqa: E402


def _structure(rng, nbr, nbc, density, ensure_diag):
    """``tests/helpers.random_bcsr``'s structure (at least one block a
    row, sorted)."""
    mask = rng.random((nbr, nbc)) < density
    for i in range(nbr):
        if not mask[i].any():
            mask[i, rng.integers(nbc)] = True
        if ensure_diag and nbr == nbc:
            mask[i, i] = True
    rows, cols = np.nonzero(mask)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32)


def pair(rng, nbr, nbc, br, bc, density=0.3, ensure_diag=False):
    """One random blocked matrix as a port ``BlockCSR`` (CPU) and a
    reference ``BlockCSR`` on the same arrays."""
    indptr, cols = _structure(rng, nbr, nbc, density, ensure_diag)
    data = rng.standard_normal((len(cols), br, bc))
    return (BlockCSR.from_arrays(indptr, cols, torch.from_numpy(data), nbc),
            RBlockCSR.from_arrays(indptr, cols, data, nbc))


def dense(A) -> np.ndarray:
    return to_np(A.to_dense())


RNG = np.random.default_rng(0)


@pytest.mark.parametrize("br,bc", [(1, 1), (3, 3), (3, 6), (6, 3), (2, 5)])
def test_to_dense_roundtrip(br, bc):
    A, R = pair(RNG, 7, 5, br, bc)
    D = dense(A)
    assert D.shape == (7 * br, 5 * bc)
    np.testing.assert_array_equal(D, np.asarray(R.to_dense()))


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (1, 1), (4, 2)])
def test_spmv_matches_dense(br, bc):
    A, R = pair(RNG, 9, 6, br, bc)
    x = RNG.standard_normal(6 * bc)
    y = to_np(spmv(A, torch.from_numpy(x)))
    np.testing.assert_allclose(y, dense(A) @ x, rtol=1e-12)
    assert_close(y, rspmv.spmv(R, jnp.asarray(x)))
    # a BlockELL goes through the same door
    assert np.array_equal(to_np(spmv(A.to_ell(), torch.from_numpy(x))), y)


def test_spmv_ell_equals_bcsr_ref():
    A, R = pair(RNG, 12, 12, 3, 3, density=0.2)
    x = torch.from_numpy(RNG.standard_normal(36))
    got = spmv_bcsr_ref(A, x)
    np.testing.assert_allclose(to_np(spmv_ell(A.to_ell(), x)), to_np(got),
                               rtol=1e-13)
    assert_close(got, rspmv.spmv_bcsr_ref(R, jnp.asarray(x.numpy())))


def test_residual_and_block_diag_apply():
    A, R = pair(RNG, 8, 8, 3, 3, ensure_diag=True)
    x, b = RNG.standard_normal(24), RNG.standard_normal(24)
    got = residual(A, torch.from_numpy(x), torch.from_numpy(b))
    assert_close(got, rspmv.residual(R, jnp.asarray(x), jnp.asarray(b)))
    dinv = RNG.standard_normal((8, 3, 3))
    for tb in (False, True):
        got = block_diag_apply(torch.from_numpy(dinv), torch.from_numpy(x),
                               transpose_blocks=tb)
        want = rspmv.block_diag_apply(jnp.asarray(dinv), jnp.asarray(x),
                                      transpose_blocks=tb)
        assert_close(got, want)
        blocks = dinv.transpose(0, 2, 1) if tb else dinv
        np.testing.assert_allclose(
            to_np(got), np.einsum("nab,nb->na", blocks,
                                  x.reshape(8, 3)).reshape(-1), rtol=1e-13)


def test_spmv_csr_ref_matches_reference():
    A, _ = pair(RNG, 10, 10, 1, 1, density=0.3)
    x = RNG.standard_normal(10)
    rows = A.row_of_nnz()
    data = to_np(A.data).reshape(-1)
    got = spmv_csr_ref(torch.from_numpy(A.indices.astype(np.int64)),
                       torch.from_numpy(data), torch.from_numpy(rows), 10,
                       torch.from_numpy(x))
    want = rspmv.spmv_csr_ref(jnp.asarray(A.indices), jnp.asarray(data),
                              jnp.asarray(rows), 10, jnp.asarray(x))
    assert_close(got, want)
    np.testing.assert_allclose(to_np(got), dense(A) @ x, rtol=1e-12)


@pytest.mark.parametrize("bk", [3, 6])
def test_spgemm_matches_dense(bk):
    A, RA = pair(RNG, 8, 6, 3, bk)
    B, RB = pair(RNG, 6, 5, bk, 6)
    C = spgemm(A, B)
    np.testing.assert_allclose(dense(C), dense(A) @ dense(B), rtol=1e-12,
                               atol=1e-12)
    RC = rspgemm.spgemm(RA, RB)
    np.testing.assert_array_equal(C.indptr, RC.indptr)
    np.testing.assert_array_equal(C.indices, RC.indices)
    assert_close(C.data, RC.data)


def test_spgemm_plan_reuse_new_values():
    A, _ = pair(RNG, 8, 8, 3, 3, ensure_diag=True)
    B, _ = pair(RNG, 8, 4, 3, 6)
    plan = spgemm_symbolic(A, B)
    C2 = spgemm_numeric(plan, A.with_data(A.data * 2.0), B)
    np.testing.assert_allclose(dense(C2), 2 * dense(A) @ dense(B),
                               rtol=1e-12, atol=1e-12)


def test_transpose():
    A, _ = pair(RNG, 6, 9, 3, 6)
    np.testing.assert_allclose(dense(transpose_bcsr(A)), dense(A).T)


def test_ptap_matches_dense_and_state_gate():
    A, RA = pair(RNG, 10, 10, 3, 3, ensure_diag=True)
    P, RP = pair(RNG, 10, 4, 3, 6)
    Ac, cache = ptap(A, P)
    Ad, Pd = dense(A), dense(P)
    np.testing.assert_allclose(dense(Ac), Pd.T @ Ad @ Pd, rtol=1e-11,
                               atol=1e-11)
    RAc, _ = rptap.ptap(RA, RP)
    assert_close(Ac.data, RAc.data)
    # hot recompute: new A values, same structures -> the gate holds
    A2 = A.with_data(A.data * -3.0)
    Ac2, cache2 = ptap(A2, P, cache)
    assert cache2 is cache, "the state gate must reuse the cache"
    np.testing.assert_allclose(dense(Ac2), Pd.T @ (-3 * Ad) @ Pd,
                               rtol=1e-11, atol=1e-11)
    assert torch.equal(ptap_numeric(cache, A2, P).data, Ac2.data)
    # a new structure object (new P) -> the gate trips
    P2 = BlockCSR.from_arrays(P.indptr, P.indices, P.data, P.nbc)
    _, cache3 = ptap(A, P2, cache)
    assert cache3 is not cache


def test_galerkin_flops_match_reference():
    A, RA = pair(RNG, 10, 10, 3, 3, ensure_diag=True)
    P, RP = pair(RNG, 10, 4, 3, 6)
    assert galerkin_flops(ptap_symbolic(A, P), 3) == \
        rptap.galerkin_flops(rptap.ptap_symbolic(RA, RP), 3) > 0


def test_block_coo_assembly_sums_duplicates_and_ignores_negative():
    br, bc = 3, 6
    rows = np.array([0, 1, 1, -1, 2, 0])
    cols = np.array([0, 1, 1, 2, 0, -3])
    vals = RNG.standard_normal((6, br, bc))
    plan = preallocate_coo(rows, cols, nbr=3, nbc=3, br=br, bc=bc)
    A = set_values_coo(plan, torch.from_numpy(vals))
    expect = np.zeros((9, 18))
    for k, (i, j) in enumerate(zip(rows, cols)):
        if i >= 0 and j >= 0:
            expect[i*br:(i+1)*br, j*bc:(j+1)*bc] += vals[k]
    np.testing.assert_allclose(dense(A), expect, rtol=1e-13)
    A2 = set_values_coo(plan, torch.from_numpy(2.0 * vals))
    np.testing.assert_allclose(dense(A2), 2 * expect, rtol=1e-13)
    assert plan.plan_bytes < scalar_coo_plan_bytes(plan)
    rplan = rcoo.preallocate_coo(rows, cols, nbr=3, nbc=3, br=br, bc=bc)
    assert plan.plan_bytes == rplan.plan_bytes
    assert scalar_coo_plan_bytes(plan) == rcoo.scalar_coo_plan_bytes(rplan)


def test_block_coo_rejects_out_of_range_coordinates():
    with pytest.raises(ValueError, match="out of range"):
        preallocate_coo(np.array([0, 3]), np.array([0, 0]),
                        nbr=3, nbc=3, br=2, bc=2)
    with pytest.raises(ValueError, match="out of range"):
        preallocate_coo(np.array([0, 1]), np.array([0, 5]),
                        nbr=3, nbc=3, br=2, bc=2)
    with pytest.raises(ValueError, match="shape mismatch"):
        preallocate_coo(np.array([0, 1]), np.array([0]),
                        nbr=3, nbc=3, br=2, bc=2)
    plan = preallocate_coo(np.array([0, -1]), np.array([0, 2]),
                           nbr=3, nbc=3, br=2, bc=2)
    assert plan.nnzb == 1


def test_block_coo_rejects_wrong_shape_value_stream():
    plan = preallocate_coo(np.array([0, 1, 2]), np.array([0, 1, 0]),
                           nbr=3, nbc=3, br=2, bc=3)
    with pytest.raises(ValueError, match="value stream shape"):
        set_values_coo(plan, torch.zeros((2, 2, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="value stream shape"):
        set_values_coo(plan, torch.zeros((3, 3, 2), dtype=torch.float64))


def test_block_axpy_union_pattern():
    X, RX = pair(RNG, 6, 6, 3, 3, density=0.2)
    Y, RY = pair(RNG, 6, 6, 3, 3, density=0.2)
    C = block_axpy(-0.5, X, Y)
    np.testing.assert_allclose(dense(C), -0.5 * dense(X) + dense(Y),
                               rtol=1e-13)
    RC = rspgemm.block_axpy(-0.5, RX, RY)
    np.testing.assert_array_equal(C.indices, RC.indices)
    assert_close(C.data, RC.data)


def test_identity():
    Ib = identity_bcsr(5, 3, device="cpu")
    np.testing.assert_allclose(dense(Ib), np.eye(15))
    assert Ib.data.dtype == torch.float64 and Ib.device.type == "cpu"


def test_spmv_rectangular_prolongator_shapes():
    P, _ = pair(RNG, 12, 3, 3, 6)
    y_f = spmv(P, torch.from_numpy(RNG.standard_normal(18)))
    assert tuple(y_f.shape) == (36,)
    R = transpose_bcsr(P)
    x_f = RNG.standard_normal(36)
    y_c = spmv(R, torch.from_numpy(x_f))
    assert tuple(y_c.shape) == (18,)
    np.testing.assert_allclose(to_np(y_c), dense(P).T @ x_f, rtol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_property.py's spgemm and block_axpy cases, at fixed seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_spgemm_associativity_with_dense(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = int(rng.integers(1, 6)), int(rng.integers(1, 6))
    A, RA = pair(rng, n1, n2, 3, 3)
    B, RB = pair(rng, n2, n1, 3, 6)
    C = spgemm(A, B)
    np.testing.assert_allclose(dense(C), dense(A) @ dense(B), rtol=1e-10,
                               atol=1e-10)
    assert_close(C.data, rspgemm.spgemm(RA, RB).data)


@pytest.mark.parametrize("seed", range(5))
def test_block_axpy_commutes_with_dense(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 7))
    bs = int(rng.choice([1, 2, 3, 6]))
    A, RA = pair(rng, n, n, bs, bs, float(rng.uniform(0.1, 0.9)))
    B, RB = pair(rng, n, n, bs, bs, 0.3)
    C = block_axpy(0.7, A, B)
    np.testing.assert_allclose(dense(C), 0.7 * dense(A) + dense(B),
                               rtol=1e-12, atol=1e-12)
    assert_close(C.data, rspgemm.block_axpy(0.7, RA, RB).data)


# ---------------------------------------------------------------------------
# The other front doors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def m4():
    prob = assemble_elasticity(4, path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=12,
                             coarsener="greedy")
    return prob, solver


def test_resmooth_prolongator_matches_the_setup(m4):
    """Re-smoothing the tentative prolongator with the cached plans gives
    the smoothed prolongator of the setup."""
    prob, solver = m4
    ls = solver.setup_data.levels[0]
    A = ls.A0
    Ptent, _ = tentative_prolongator(ls.aggr, prob.B, A.br)
    P, omega, _, plans = smoothed_prolongator(A, Ptent)
    dinv = invert_diag_blocks(A.diagonal_blocks())
    got = resmooth_prolongator_data(
        plans["ap_plan"], plans["axpy_plan"], A.data, dinv, omega,
        Ptent.data, torch.as_tensor(A.row_of_nnz()))
    assert_close(got, P.data)
    assert_close(scale_rows_data(A, dinv),
                 torch.einsum("nab,nbc->nac",
                              dinv[torch.as_tensor(A.row_of_nnz())], A.data))


def test_hot_closures_are_hier_solve(m4):
    """``make_recompute`` / ``make_solve`` are the eager closures of
    ``recompute`` / ``hier_solve``; ``vcycle_apply_op`` the fine apply."""
    prob, solver = m4
    s = solver.setup_data
    hier = gamg.make_recompute(s)(prob.A.data)
    res = gamg.make_solve(s, rtol=1e-8, maxiter=100)(hier, prob.b)
    want = gamg.hier_solve(s, solver.hierarchy, prob.b, rtol=1e-8,
                           maxiter=100)
    assert res.iters == want.iters and torch.equal(res.x, want.x)
    warm = gamg.make_solve(s)(hier, prob.b, res.x)
    assert warm.iters == 0
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(prob.n))
    assert torch.equal(vcycle_apply_op(hier, x),
                       spmv_ell(fine_operator(hier), x))


def test_nnz_per_row_estimate_matches_reference():
    for order in (1, 2):
        assert nnz_per_row_estimate(order) == ref_nnz_estimate(order)


def test_prometheus_round_trip_and_default_registry():
    reg = MetricsRegistry()
    reg.counter("solver/requests", help="requests").inc(3)
    reg.gauge("queue-depth").set(2.5)
    h = reg.histogram("solve_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.to_prometheus()
    out = parse_prometheus(text)
    assert out == ref_parse_prometheus(text)
    assert out["solver_requests"][""] == 3.0
    assert out["queue_depth"][""] == 2.5
    buckets = out["solve_seconds_bucket"]
    assert buckets['{le="+Inf"}'] == 3.0 and buckets['{le="0.1"}'] == 1.0
    assert out["solve_seconds_count"][""] == 3.0
    reset_default_registry()
    a = default_registry()
    assert default_registry() is a
    reset_default_registry()
    assert default_registry() is not a


# ---------------------------------------------------------------------------
# The torch quickstart against examples/quickstart.py's setting
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference_at_m4():
    """``python -m repro_torch.quickstart 4 --device cpu`` against the
    reference's quickstart setting (device assembly, MIS,
    ``coarse_size=40``, rtol 1e-8, maxiter 100, 3 reused-hierarchy
    steps): levels and per-step iterations equal."""
    got = quickstart.main(4, device="cpu")
    rp = ref_assemble(4)
    rs = rgamg.GAMGSolver(rp.A, rp.B, coarse_size=40, rtol=1e-8,
                          maxiter=100)
    iters = []
    for step in range(3):
        rs.update_operator(rp.reassemble(1.0 + 0.1 * step).data)
        iters.append(int(rs.solve(rp.b).iters))
    assert got["level_rows"] == rs.setup_data.stats["level_rows"]
    assert got["iters"] == iters
    assert got["converged"]


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        identity_bcsr(2, 3)
