"""The stored restriction (``setup(restriction="stored")``) against
``repro``'s, and against the port's own transpose-free mode.

The reference holds its two modes bitwise (``tests/test_transpose_free
.py``).  In the port the stored ``r_ell`` runs through ``block_spmv`` /
``block_spmm`` (on the card their lanes butterfly) while the
transpose-free apply is a gather plus einsum, so the modes are held
bitwise here on the CPU only where the plain versions share an order
(the restriction and the solve, as checked below), and otherwise to equal
iterations and 1e-12 relative.  Case: m=5, greedy, ``coarse_size=6``
(levels ``[300, 48, 12]``: a 6x3 ``R0`` and a 6x6 ``R1``).  Also the
plain versions of the 6x3 ``block_spmv`` / ``block_spmm`` against a dense
product at every payload dtype."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core.vcycle import vcycle as ref_vcycle  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.multirhs.block_krylov import \
    make_block_solve as ref_block_solve  # noqa: E402

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.block_csr import transpose_bcsr  # noqa: E402
from repro_torch.core.spmv import apply_ell, apply_ell_t  # noqa: E402
from repro_torch.core.vcycle import apply_restriction, vcycle  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy, \
    setup_from_numpy  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref  # noqa
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref  # noqa
from repro_torch.multirhs.block_krylov import make_block_solve  # noqa: E402

from torch_helpers import assert_close, hierarchy_to_numpy, \
    setup_to_numpy, to_np  # noqa: E402

M, COARSE = 5, 6
LEVELS = [300, 48, 12]
OPTS = dict(coarse_size=COARSE, coarsener="greedy")


@pytest.fixture(scope="module")
def case():
    rp = ref_assemble(M, path="host")
    ref = ref_gamg.GAMGSolver(rp.A, rp.B, restriction="stored", **OPTS)
    pp = assemble_elasticity(M, path="host", device="cpu")
    port = {mode: gamg.GAMGSolver(pp.A, pp.B, restriction=mode, **OPTS)
            for mode in ("stored", "transpose_free")}
    return dict(rp=rp, ref=ref, pp=pp, port=port)


def test_stored_setup_matches_reference(case):
    """Levels as the reference's; ``R`` and ``r_ell`` structures bitwise,
    payloads to 1e-12; no transpose-apply plan in stored mode."""
    ref, port = case["ref"].setup_data, case["port"]["stored"].setup_data
    assert ref.stats["level_rows"] == port.stats["level_rows"] == LEVELS
    assert [tuple(ls.r_ell.data.shape[2:]) for ls in port.levels] == \
        [(6, 3), (6, 6)]
    for rl, pl in zip(ref.levels, port.levels):
        assert pl.pt is None and rl.pt is None
        np.testing.assert_array_equal(pl.R.indptr, rl.R.indptr)
        np.testing.assert_array_equal(pl.R.indices, rl.R.indices)
        assert_close(pl.R.data, rl.R.data)
        np.testing.assert_array_equal(to_np(pl.r_ell.indices),
                                      np.asarray(rl.r_ell.indices))
        np.testing.assert_array_equal(to_np(pl.r_ell.mask),
                                      np.asarray(rl.r_ell.mask))
        assert_close(pl.r_ell.data, rl.r_ell.data)


def test_restriction_bcsr(case):
    """``restriction_bcsr`` returns the stored ``R``, and on a
    transpose-free setup the transpose, bitwise the stored one."""
    st = case["port"]["stored"].setup_data
    tf = case["port"]["transpose_free"].setup_data
    for ls_s, ls_t in zip(st.levels, tf.levels):
        assert gamg.restriction_bcsr(ls_s) is ls_s.R
        assert ls_t.R is None and ls_t.r_ell is None
        R = gamg.restriction_bcsr(ls_t)
        np.testing.assert_array_equal(R.indptr, ls_s.R.indptr)
        np.testing.assert_array_equal(R.indices, ls_s.R.indices)
        assert torch.equal(R.data, ls_s.R.data)
        assert torch.equal(R.data, transpose_bcsr(ls_t.P).data)


def test_stored_restriction_is_the_transpose_free_one(case):
    """On the CPU the plain versions share an order: the stored apply is
    bitwise the transpose-free one, vectors and panels, every level."""
    st = case["port"]["stored"].hierarchy
    tf = case["port"]["transpose_free"].hierarchy
    gen = torch.Generator().manual_seed(3)
    for ls, lt in zip(st.levels, tf.levels):
        n = ls.p_ell.nbr * ls.p_ell.br
        for shape in ((n,), (n, 4)):
            r = torch.randn(shape, generator=gen, dtype=torch.float64)
            got = apply_restriction(ls, r)
            assert torch.equal(got, apply_ell(ls.r_ell, r))
            assert torch.equal(got, apply_ell_t(lt.p_ell, lt.p_t, r))
            assert torch.equal(got, apply_restriction(lt, r))


def test_stored_vcycle_matches_reference(case):
    """The port's V-cycle on the reference's stored hierarchy (carried
    across through numpy) against the reference's, to 1e-12."""
    ref = case["ref"]
    levels, chol = hierarchy_to_numpy(ref.hierarchy)
    assert all(lv["p_t"] is None and lv["r_ell"] is not None
               for lv in levels)
    hier = hierarchy_from_numpy(levels, chol, device="cpu")
    b = np.random.default_rng(5).standard_normal(LEVELS[0])
    want = ref_vcycle(ref.hierarchy, jnp.asarray(b))
    assert_close(vcycle(hier, torch.from_numpy(b)), want)


def test_setup_from_numpy_carries_the_stored_restriction(case):
    levels, coarse = setup_to_numpy(case["ref"].setup_data)
    got = setup_from_numpy(levels, coarse, coarsener="greedy",
                           device="cpu")
    port = case["port"]["stored"].setup_data
    for gl, pl in zip(got.levels, port.levels):
        assert gl.pt is None
        np.testing.assert_array_equal(gl.R.indices, pl.R.indices)
        assert torch.equal(gl.r_ell.indices, pl.r_ell.indices)
        assert_close(gl.r_ell.data, pl.r_ell.data)
    hier = gamg.recompute(got, case["pp"].A.data)
    assert all(lv.r_ell is not None for lv in hier.levels)


def test_stored_solve_matches_reference_and_transpose_free(case):
    """Iterations equal to the reference's stored solve, the solution to
    1e-12; the port's two modes bitwise on the CPU."""
    rr = case["ref"].solve(jnp.asarray(case["rp"].b))
    st = case["port"]["stored"].solve(case["pp"].b)
    tf = case["port"]["transpose_free"].solve(case["pp"].b)
    assert st.iters == int(rr.iters) == tf.iters
    assert int(st.health.status) == 0
    assert_close(st.x, rr.x)
    assert torch.equal(st.x, tf.x)


def test_stored_panel_solve_matches_reference(case):
    """The k=3 panel solve in stored mode: per-column iterations as the
    reference's, solutions to 1e-12, and within 1e-12 of the port's
    transpose-free panel solve."""
    rng = np.random.default_rng(7)
    B = rng.standard_normal((LEVELS[0], 3))
    ref = case["ref"]
    want = ref_block_solve(ref.setup_data)(ref.hierarchy, jnp.asarray(B))
    got = {}
    for mode, solver in case["port"].items():
        got[mode] = make_block_solve(solver.setup_data)(
            solver.hierarchy, torch.from_numpy(B))
    np.testing.assert_array_equal(to_np(got["stored"].iters),
                                  np.asarray(want.iters))
    np.testing.assert_array_equal(to_np(got["transpose_free"].iters),
                                  np.asarray(want.iters))
    assert_close(got["stored"].x, want.x)
    assert_close(got["stored"].x, got["transpose_free"].x)


# ---------------------------------------------------------------------------
# The 6x3 kernels' plain versions against a dense product
# ---------------------------------------------------------------------------

TOL = {torch.float64: 1e-12, torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _ell_6x3(dtype, nbr=9, nbc=13, kmax=5, seed=0):
    """A random 6x3 BlockELL at ``dtype``: padded slots are zero blocks at
    column 0."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nbc, size=(nbr, kmax)).astype(np.int32)
    mask = rng.random((nbr, kmax)) < 0.8
    idx[~mask] = 0
    data = rng.standard_normal((nbr, kmax, 6, 3)) * mask[..., None, None]
    return torch.from_numpy(idx), torch.from_numpy(data).to(dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=["f64", "f32", "bf16"])
def test_6x3_plain_versions_match_a_dense_product(dtype):
    idx, data = _ell_6x3(dtype)
    nbr, kmax, nbc = data.shape[0], data.shape[1], 13
    data_r = data.double().numpy()      # the payload as stored (rounded)
    dense = np.zeros((nbr * 6, nbc * 3))
    for r in range(nbr):
        for k in range(kmax):
            c = int(idx[r, k])
            dense[6 * r:6 * r + 6, 3 * c:3 * c + 3] += data_r[r, k]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((nbc, 3))
    X = rng.standard_normal((nbc, 3, 4))
    xt = torch.from_numpy(x).to(dtype)
    Xt = torch.from_numpy(X).to(dtype)
    xr, Xr = xt.double().numpy(), Xt.double().numpy()
    y = block_spmv_ell_ref(idx, data, xt)
    assert y.dtype == dtype and tuple(y.shape) == (nbr, 6)
    assert_close(y.double(), (dense @ xr.reshape(-1)).reshape(nbr, 6),
                 TOL[dtype])
    Y = block_spmm_ell_ref(idx, data, Xt)
    assert tuple(Y.shape) == (nbr, 6, 4)
    assert_close(Y.double(), (dense @ Xr.reshape(nbc * 3, 4)).reshape(
        nbr, 6, 4), TOL[dtype])
    # the wrappers take the plain versions on the CPU and count nothing
    before = (spmv_ops.launches, spmm_ops.launches)
    assert torch.equal(spmv_ops.block_spmv_ell(idx, data, xt), y)
    assert torch.equal(spmm_ops.block_spmm_ell(idx, data, Xt), Y)
    assert (spmv_ops.launches, spmm_ops.launches) == before


def test_6x3_has_a_kernel_instantiation():
    assert (6, 3) in spmv_ops.SHAPES and (6, 3) in spmm_ops.SHAPES
