"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode) and their ``ref.py`` oracles, at the paths'
block shapes.  The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402

from repro.core.spgemm import spgemm_numeric_data as ref_spgemm  # noqa: E402
from repro.core.spgemm import spgemm_symbolic as ref_symbolic  # noqa: E402
from repro.core.spgemm import block_axpy_symbolic as ref_axpy  # noqa: E402
from repro.core.block_csr import BlockELL as RefELL  # noqa: E402
from repro.core.spmv import spmm_ell as ref_spmm_ell  # noqa: E402
from repro.kernels.block_pair_gemm.block_pair_gemm import (  # noqa: E402
    block_pair_gemm as pl_pair,
)
from repro.kernels.block_seg_sum.ops import block_seg_sum as pl_seg  # noqa
from repro.kernels.block_spmm.block_spmm import block_spmm_ell as pl_spmm  # noqa
from repro.kernels.block_seg_sum.ref import block_seg_sum_ref as jnp_seg  # noqa
from repro.kernels.block_spmv.block_spmv import block_spmv_ell as pl_spmv  # noqa
from repro.kernels.block_spmv.ref import block_spmv_ell_ref as jnp_spmv  # noqa
from repro.kernels.fused_pair_gemm.fused_pair_gemm import (  # noqa: E402
    fused_pair_gemm as pl_gemm,
)
from repro.kernels.fused_pair_gemm.ref import (  # noqa: E402
    fused_pair_gemm_ref as jnp_gemm,
)
from repro.kernels.fused_smoother.fused_smoother import (  # noqa: E402
    smoother_step_ell as pl_smooth,
)
from repro.kernels.fused_smoother.ref import (  # noqa: E402
    smoother_step_ref as jnp_smooth,
)
from repro.kernels.pbjacobi.ops import pbjacobi_apply as pl_pbj_apply  # noqa
from repro.kernels.pbjacobi.pbjacobi import pbjacobi_update as pl_pbj  # noqa
from repro.kernels.pbjacobi.ref import pbjacobi_update_ref as jnp_pbj  # noqa

from repro_torch.core import spgemm as t_spgemm  # noqa: E402
from repro_torch.interop import bcsr_from_numpy  # noqa: E402
from repro_torch.kernels.block_pair_gemm import ops as pair_ops  # noqa
from repro_torch.kernels.block_seg_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.pbjacobi import ops as pbj_ops  # noqa: E402

from helpers import random_bcsr  # noqa: E402
from torch_helpers import assert_close, bcsr_dict  # noqa: E402

BLOCKS = [(3, 3), (3, 6), (6, 6)]
PRODUCTS = [(3, 3, 6), (6, 3, 6), (6, 6, 6)]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("br,bc", BLOCKS)
@pytest.mark.parametrize("with_perm", [False, True], ids=["sorted", "perm"])
def test_seg_sum_plain_matches_pallas_and_ref(br, bc, with_perm):
    rng = np.random.default_rng(br * 10 + bc)
    n, nseg = 240, 70
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    seg[seg == 5] = 6                     # an empty segment
    vals = rng.standard_normal((n, br, bc))
    perm = rng.permutation(n).astype(np.int32) if with_perm else None
    stream = vals[perm] if with_perm else vals
    offsets = np.zeros(nseg + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=nseg), out=offsets[1:])
    got = seg_ops.block_seg_sum(
        _t(vals), _t(offsets, torch.int32),
        None if perm is None else _t(perm, torch.int32))
    want_ref = jnp_seg(jnp.asarray(stream), jnp.asarray(seg), nseg)
    want_pl = pl_seg(jnp.asarray(stream), jnp.asarray(seg), nseg,
                     interpret=True)
    # same in-order sum as the sorted segment_sum: bitwise
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    assert_close(got, want_pl)
    assert np.all(got.numpy()[5] == 0.0)


@pytest.mark.parametrize("br,bc", BLOCKS)
def test_spmv_plain_matches_pallas_and_ref(br, bc):
    rng = np.random.default_rng(100 + br * 10 + bc)
    A = random_bcsr(rng, 23, 17, br, bc, density=0.3)
    ell = A.to_ell()
    x = rng.standard_normal((A.nbc, bc))
    got = spmv_ops.block_spmv_ell(_t(ell.indices, torch.int32),
                                  _t(ell.data), _t(x))
    assert_close(got, jnp_spmv(ell.indices, ell.data, jnp.asarray(x)))
    assert_close(got, pl_spmv(ell.indices, ell.data, jnp.asarray(x),
                              interpret=True))


@pytest.mark.parametrize("br,bc", BLOCKS)
@pytest.mark.parametrize("k", [1, 3, 16])
def test_spmm_plain_matches_pallas_and_spmm_ell(br, bc, k):
    rng = np.random.default_rng(150 + br * 10 + bc + k)
    A = random_bcsr(rng, 23, 17, br, bc, density=0.3)
    ell = A.to_ell()
    x = rng.standard_normal((A.nbc, bc, k))
    got = spmm_ops.block_spmm_ell(_t(ell.indices, torch.int32),
                                  _t(ell.data), _t(x))
    assert got.shape == (A.nbr, br, k)
    assert_close(got, pl_spmm(ell.indices, ell.data, jnp.asarray(x),
                              interpret=True))
    want = ref_spmm_ell(RefELL(indices=ell.indices, data=ell.data,
                               mask=ell.mask, nbc=ell.nbc),
                        jnp.asarray(x.reshape(A.nbc * bc, k)))
    assert_close(got.reshape(A.nbr * br, k), want)


@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_block_pair_gemm_plain_matches_pallas(br, bk, bc):
    rng = np.random.default_rng(250 + br * 100 + bk * 10 + bc)
    lhs = rng.standard_normal((301, br, bk))
    rhs = rng.standard_normal((301, bk, bc))
    got = pair_ops.block_pair_gemm(_t(lhs), _t(rhs))
    assert_close(got, pl_pair(jnp.asarray(lhs), jnp.asarray(rhs),
                              interpret=True))
    assert_close(got, np.einsum("pij,pjk->pik", lhs, rhs))


@pytest.mark.parametrize("bs", [3, 6])
def test_smoother_panel_plain_matches_pallas(bs):
    rng = np.random.default_rng(220 + bs)
    A = random_bcsr(rng, 19, 19, bs, bs, density=0.3, ensure_diag=True)
    ell = A.to_ell()
    dinv = rng.standard_normal((19, bs, bs))
    b, x, d = (rng.standard_normal((19, bs, 5)) for _ in range(3))
    coef = np.array([0.4, -1.3])
    got = smooth_ops.smoother_step_ell(
        _t(ell.indices, torch.int32), _t(ell.data), _t(dinv), _t(b), _t(x),
        _t(d), _t(coef))
    want = pl_smooth(ell.indices, ell.data, *(
        jnp.asarray(a) for a in (dinv, b, x, d, coef)), interpret=True)
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])


@pytest.mark.parametrize("bs", [3, 6])
def test_smoother_plain_matches_pallas_and_ref(bs):
    rng = np.random.default_rng(200 + bs)
    A = random_bcsr(rng, 19, 19, bs, bs, density=0.3, ensure_diag=True)
    ell = A.to_ell()
    dinv, b, x, d = (rng.standard_normal(s) for s in
                     ((19, bs, bs), (19, bs), (19, bs), (19, bs)))
    coef = np.array([0.4, -1.3])
    got = smooth_ops.smoother_step_ell(
        _t(ell.indices, torch.int32), _t(ell.data), _t(dinv), _t(b), _t(x),
        _t(d), _t(coef))
    jargs = (ell.indices, ell.data) + tuple(
        jnp.asarray(a) for a in (dinv, b, x, d, coef))
    for want in (jnp_smooth(*jargs), pl_smooth(*jargs, interpret=True)):
        assert_close(got[0], want[0])
        assert_close(got[1], want[1])


def _product(rng, br, bk, bc, skew=False):
    A = random_bcsr(rng, 21, 15, br, bk, density=0.25)
    B = random_bcsr(rng, 15, 12, bk, bc, density=0.35)
    if skew:        # one dense row of A: its output blocks split into rows
        A = random_bcsr(rng, 21, 15, br, bk, density=0.15)
        dense = random_bcsr(rng, 1, 15, br, bk, density=1.0)
        indptr = np.concatenate([dense.indptr, A.indptr[1:] + 15])
        indices = np.concatenate([dense.indices, A.indices])
        data = np.concatenate([np.asarray(dense.data), np.asarray(A.data)])
        from repro.core.block_csr import BlockCSR
        A = BlockCSR.from_arrays(indptr, indices, data, 15)
        B = random_bcsr(rng, 15, 3, bk, bc, density=0.9)
    return A, B


SPGEMM_PLAN_FIELDS = ("indptr", "indices", "pair_a", "pair_b", "out_idx",
                      "tile_pair_a", "tile_pair_b", "tile_mask", "tile_seg")


def _same_fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(g, np.ndarray), name
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_symbolic_plans_are_the_references_at_any_chunk(br, bk, bc, skew,
                                                        chunk):
    """The torch symbolic phases, in row ranges of 1 or 7 pairs (blocks)
    or in one, give every plan field of ``repro``'s numpy ones: dtype,
    shape and values."""
    rng = np.random.default_rng(600 + br * 100 + bk * 10 + bc + 5 * skew)
    A, B = _product(rng, br, bk, bc, skew=skew)
    tA = bcsr_from_numpy(**bcsr_dict(A), device="cpu")
    tB = bcsr_from_numpy(**bcsr_dict(B), device="cpu")
    want = ref_symbolic(A, B)
    got = t_spgemm.spgemm_symbolic(tA, tB, chunk_pairs=chunk)
    _same_fields(got, want, SPGEMM_PLAN_FIELDS)
    assert (got.nnzb, got.tile_identity) == (want.nnzb, want.tile_identity)
    Y = random_bcsr(rng, A.nbr, A.nbc, br, bk, density=0.3)
    tY = bcsr_from_numpy(**bcsr_dict(Y), device="cpu")
    want = ref_axpy(A, Y)
    got = t_spgemm.block_axpy_symbolic(tA, tY, chunk_blocks=chunk)
    _same_fields(got, want, ("indptr", "indices", "x_slot", "y_slot"))
    assert got.nnzb == want.nnzb


@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_pair_gemm_plain_matches_pallas_and_ref(br, bk, bc):
    rng = np.random.default_rng(300 + br * 100 + bk * 10 + bc)
    A, B = _product(rng, br, bk, bc)
    plan = ref_symbolic(A, B)
    a, b = np.asarray(A.data), np.asarray(B.data)
    got = gemm_ops.fused_pair_gemm(
        _t(a), _t(b), _t(plan.tile_pair_a, torch.int32),
        _t(plan.tile_pair_b, torch.int32), _t(plan.tile_mask, torch.bool))
    lhs = np.where(plan.tile_mask[..., None, None], a[plan.tile_pair_a], 0)
    rhs = b[plan.tile_pair_b]
    assert_close(got, jnp_gemm(jnp.asarray(lhs), jnp.asarray(rhs)))
    assert_close(got, pl_gemm(jnp.asarray(lhs), jnp.asarray(rhs),
                              interpret=True))


@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_fused_spgemm_with_row_splits_matches_pallas(br, bk, bc):
    """The whole fused numeric phase, including the seg-sum combine of
    split tile rows (``tile_identity`` False)."""
    rng = np.random.default_rng(400 + br * 100 + bk * 10 + bc)
    A, B = _product(rng, br, bk, bc, skew=True)
    plan = ref_symbolic(A, B)
    assert not plan.tile_identity
    tA = bcsr_from_numpy(**bcsr_dict(A), device="cpu")
    tB = bcsr_from_numpy(**bcsr_dict(B), device="cpu")
    tplan = t_spgemm.spgemm_symbolic(tA, tB)
    for name in ("tile_pair_a", "tile_pair_b", "tile_mask", "tile_seg"):
        np.testing.assert_array_equal(getattr(tplan, name),
                                      getattr(plan, name))
    want = ref_spgemm(plan, A.data, B.data, path="fused", interpret=True)
    for path in ("fused", "reference"):
        got = t_spgemm.spgemm_numeric_data(tplan, tA.data, tB.data,
                                           path=path)
        assert_close(got, want)


@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_pairs_spgemm_matches_reference(br, bk, bc):
    """The "pairs" numeric path (gather, ``block_pair_gemm``,
    ``block_seg_sum``) against the reference's unfused einsum +
    ``segment_sum`` path."""
    rng = np.random.default_rng(500 + br * 100 + bk * 10 + bc)
    A, B = _product(rng, br, bk, bc, skew=True)
    plan = ref_symbolic(A, B)
    tA = bcsr_from_numpy(**bcsr_dict(A), device="cpu")
    tB = bcsr_from_numpy(**bcsr_dict(B), device="cpu")
    tplan = t_spgemm.spgemm_symbolic(tA, tB)
    want = ref_spgemm(plan, A.data, B.data, path="reference")
    got = t_spgemm.spgemm_numeric_data(tplan, tA.data, tB.data, path="pairs")
    assert_close(got, want)


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("nbr", [1, 37, 256])
def test_pbjacobi_plain_matches_pallas_and_ref(bs, nbr):
    """``x + omega D^-1 r``; 37 rows are ragged against the reference's
    64-row tile."""
    rng = np.random.default_rng(600 + 10 * bs + nbr)
    dinv = rng.standard_normal((nbr, bs, bs))
    r, x = rng.standard_normal((nbr, bs)), rng.standard_normal((nbr, bs))
    got = pbj_ops.pbjacobi_update(_t(dinv), _t(r), _t(x), 0.7)
    jargs = tuple(jnp.asarray(a) for a in (dinv, r, x))
    assert_close(got, jnp_pbj(*jargs, 0.7))
    assert_close(got, pl_pbj(*jargs, jnp.asarray(0.7), interpret=True))
    # omega as a one-element tensor, and the flat front door
    assert_close(pbj_ops.pbjacobi_update(_t(dinv), _t(r), _t(x),
                                         torch.tensor([0.7], dtype=torch.float64)),
                 got)
    flat = pbj_ops.pbjacobi_apply(_t(dinv), _t(r.reshape(-1)),
                                  _t(x.reshape(-1)), 0.7,
                                  accum_dtype=torch.float64)
    assert flat.shape == (nbr * bs,)
    assert_close(flat, pl_pbj_apply(jargs[0], jargs[1].reshape(-1),
                                    jargs[2].reshape(-1), 0.7,
                                    interpret=True))


def test_pbjacobi_apply_refuses_sub_f64_accumulation():
    """``pbjacobi_apply`` with an f32 accumulator (f32 payloads, and bf16
    payloads accumulating at f32) matches the reference's Pallas kernel at
    the reference's tolerances (``tests/test_kernels.py``)."""
    import ml_dtypes
    rng = np.random.default_rng(11)
    nbr, bs = 17, 3
    dinv, r, x = (rng.standard_normal(s) for s in ((nbr, bs, bs),
                                                   (nbr * bs,), (nbr * bs,)))
    for np_dt, t_dt, tol in ((np.float32, torch.float32, 2e-5),
                             (ml_dtypes.bfloat16, torch.bfloat16, 5e-2)):
        arrs = [a.astype(np_dt) for a in (dinv, r, x)]
        want = pl_pbj_apply(*(jnp.asarray(a) for a in arrs), 0.5,
                            interpret=True, accum_dtype=np.float32)
        got = pbj_ops.pbjacobi_apply(
            *(torch.from_numpy(a.astype(np.float32)).to(t_dt)
              for a in arrs), 0.5, accum_dtype=torch.float32)
        assert got.dtype == t_dt
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64), rtol=tol,
                                   atol=tol)
