"""The scalar (AIJ) baseline (``repro_torch.core.scalar_csr`` /
``scalar_path``) against ``repro``'s on the CPU.

Case: ``assemble_elasticity(5)`` and ``gamg.setup(coarse_size=30,
precision="f64")`` in the reference (its defaults: device assembly, the
MIS coarsener), carried across to the port through numpy
(``interop.setup_from_numpy``), so both sides expand and solve the same
setup.  The expansion's structure is held bitwise, payloads and the
scalar PtAP chain to the reference's own tolerances (1e-12 and 1e-11),
the scalar solve to the reference's iterations and
``tests/test_amg_convergence.py``'s tolerance.  Also the quarantine twin
of ``tests/test_no_scalar_expansion.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core import scalar_csr as ref_scalar_csr  # noqa: E402
from repro.core import scalar_path as ref_scalar_path  # noqa: E402
from repro.core.block_csr import transpose_bcsr as ref_transpose  # noqa
from repro.core.vcycle import chebyshev_smooth as ref_chebyshev  # noqa
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core import scalar_csr, scalar_path  # noqa: E402
from repro_torch.core.block_csr import BlockCSR  # noqa: E402
from repro_torch.core.ptap import ptap_numeric_data  # noqa: E402
from repro_torch.core.spmv import spmv_ell  # noqa: E402
from repro_torch.core.vcycle import chebyshev_smooth_fused  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import bcsr_from_numpy, setup_from_numpy  # noqa
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa

from torch_helpers import assert_close, bcsr_dict, rel_err, \
    setup_to_numpy, to_np  # noqa: E402

M, COARSE = 5, 30
SEED = 23
CHAIN_REL = 1e-11        # tests/test_scalar_chain.py
X_RTOL, X_ATOL = 1e-6, 1e-10     # tests/test_amg_convergence.py:107-109


def _port_setup(ref, precision="f64"):
    levels, coarse = setup_to_numpy(ref)
    return setup_from_numpy(levels, coarse, precision=precision,
                            coarsener=ref.coarsener, device="cpu")


@pytest.fixture(scope="module")
def case():
    rp = ref_assemble(M)
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=COARSE, precision="f64")
    port = _port_setup(ref)
    a = to_np(rp.A.data)
    return dict(rp=rp, ref=ref, port=port, a=a,
                a_t=torch.from_numpy(a.copy()),
                b_t=torch.from_numpy(to_np(rp.b).copy()))


def _operators(ref):
    """The 3x3, 3x6, 6x3 and 6x6 operators of the reference's setup."""
    ls = ref.levels[0]
    return {"A0 3x3": ls.A0, "P0 3x6": ls.P, "R0 6x3": ref_transpose(ls.P),
            "A1 6x6": ref.coarse_struct}


@pytest.mark.parametrize("name", ["A0 3x3", "P0 3x6", "R0 6x3", "A1 6x6"])
def test_expand_bcsr_matches_reference(case, name):
    """Structure bitwise, payload equal (a gather moves no bits), the
    expand map and both byte formulas equal."""
    A = _operators(case["ref"])[name]
    want = ref_scalar_csr.expand_bcsr(A)
    P = bcsr_from_numpy(**bcsr_dict(A), device="cpu")
    got = scalar_csr.expand_bcsr(P)
    assert (got.br, got.bc) == (1, 1) and got.nbc == want.nbc
    np.testing.assert_array_equal(got.indptr, np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    assert got.indptr.dtype == np.int64 and got.indices.dtype == np.int32
    np.testing.assert_array_equal(to_np(got.data), np.asarray(want.data))
    emap = scalar_path.expand_map(P)
    np.testing.assert_array_equal(emap, ref_scalar_path.expand_map(A))
    np.testing.assert_array_equal(
        to_np(P.data).reshape(-1)[emap], np.asarray(want.data).reshape(-1))
    for fn in ("csr_matrix_bytes", "bcsr_matrix_bytes"):
        for kw in ({}, dict(value_bytes=4, index_bytes=4)):
            assert getattr(scalar_csr, fn)(P, **kw) == \
                getattr(ref_scalar_csr, fn)(A, **kw)


def test_scalar_ell_plan_is_the_expanded_ell(case):
    """The cached plan's one gather from the blocked payload builds
    ``expand_bcsr(A).to_ell()`` bitwise."""
    ls = case["port"].levels[0]
    a = case["a_t"] * 1.3
    got = scalar_path.scalar_ell_plan(ls.A0).build(a.reshape(-1, 1, 1))
    want = scalar_csr.expand_bcsr(ls.A0.with_data(a)).to_ell()
    for key in ("indices", "data", "mask"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    assert got.nbc == want.nbc


def test_scalar_ptap_chain_matches_reference(case):
    """Per level within 1e-11 of the reference's chain, and of the
    expansion of the port's blocked chain (``tests/test_scalar_chain.py``
    on the port)."""
    ref, port = case["ref"], case["port"]
    want = ref_scalar_path.build_scalar_ptap_chain(ref)(case["rp"].A.data)
    got = scalar_path.build_scalar_ptap_chain(port)(case["a_t"])
    assert len(got) == len(want) == len(port.levels)
    a = case["a_t"]
    for ls, g, w in zip(port.levels, got, want):
        assert g.shape == tuple(w.shape)
        assert_close(g, w, CHAIN_REL)
        a = ptap_numeric_data(ls.ptap_cache, a, ls.P.data)
        blocked = BlockCSR.from_arrays(
            ls.ptap_cache.ac_plan.indptr, ls.ptap_cache.ac_plan.indices, a,
            ls.ptap_cache.n_coarse)
        assert_close(g, scalar_csr.expand_bcsr(blocked).data, CHAIN_REL)


def test_each_operator_expanded_once_per_setup(case, monkeypatch):
    """The scalar levels and the scalar chain share one host expansion of
    each level's ``A0`` and ``P`` (cached on the setup); only the stored
    restriction, another operator, is expanded apart.  The chain's
    ``expand_fine`` is the expansion of the fine payload."""
    port = _port_setup(case["ref"])
    real, calls = scalar_csr.expand_structure, []

    def counted(A):
        calls.append(A.nnzb)
        return real(A)

    monkeypatch.setattr(scalar_path, "expand_structure", counted)
    monkeypatch.setattr(scalar_csr, "expand_structure", counted)
    n = len(port.levels)
    scalar_path.scalar_levels(port)
    assert len(calls) == 3 * n          # A0, P, the stored restriction
    chain = scalar_path.build_scalar_ptap_chain(port)
    scalar_path.scalar_levels(port)
    assert len(calls) == 3 * n
    A0 = port.levels[0].A0
    want = real(A0)[2]
    assert torch.equal(chain.expand_fine(case["a_t"]).reshape(-1),
                       case["a_t"].reshape(-1)[torch.from_numpy(want)])


def test_recompute_scalar_matches_reference(case):
    """Every level's scalar ``a_ell`` / ``p_ell`` / ``r_ell``: indices and
    masks bitwise, payloads within 1e-12; the blocked ``dinv`` and
    ``lam_max``; the coarse factor."""
    want = ref_scalar_path.recompute_scalar(case["ref"],
                                            case["rp"].A.data)
    got = scalar_path.recompute_scalar(case["port"], case["a_t"])
    assert len(got.levels) == len(want.levels)
    for gl, wl in zip(got.levels, want.levels):
        for key in ("a_ell", "p_ell", "r_ell"):
            g, w = getattr(gl, key), getattr(wl, key)
            assert (g.br, g.bc, g.nbc) == (1, 1, w.nbc), key
            np.testing.assert_array_equal(to_np(g.indices),
                                          np.asarray(w.indices))
            np.testing.assert_array_equal(to_np(g.mask), np.asarray(w.mask))
            assert_close(g.data, w.data)
        assert gl.p_t is None
        assert_close(gl.dinv, wl.dinv)
        assert_close(gl.lam_max, wl.lam_max)
    assert_close(got.coarse_chol, want.coarse_chol)
    assert got.a_fine_ell is None and want.a_fine_ell is None


def _ref_solve(setupd, hier, b):
    res = ref_gamg.hier_solve(setupd, hier, b, rtol=1e-8, maxiter=100)
    return int(res.iters), to_np(res.x)


def test_scalar_solve_matches_reference(case):
    """The port's scalar solve (``gamg.hier_solve`` on the scalar
    hierarchy) at the iterations of the reference's scalar and blocked
    solves, within ``tests/test_amg_convergence.py``'s tolerance of the
    blocked solution; and against the reference's scalar solution."""
    ref, port, rp = case["ref"], case["port"], case["rp"]
    it_rb, x_rb = _ref_solve(ref, ref_gamg.recompute(ref, rp.A.data), rp.b)
    it_rs, x_rs = _ref_solve(
        ref, ref_scalar_path.recompute_scalar(ref, rp.A.data), rp.b)
    hier = scalar_path.recompute_scalar(port, case["a_t"])
    res = gamg.hier_solve(port, hier, case["b_t"], rtol=1e-8, maxiter=100)
    assert int(res.iters) == it_rs == it_rb
    assert bool(res.converged)
    np.testing.assert_allclose(to_np(res.x), x_rb, rtol=X_RTOL, atol=X_ATOL)
    np.testing.assert_allclose(to_np(res.x), x_rs, rtol=X_RTOL, atol=X_ATOL)
    blocked = gamg.hier_solve(port, gamg.recompute(port, case["a_t"]),
                              case["b_t"], rtol=1e-8, maxiter=100)
    assert int(blocked.iters) == int(res.iters)


def test_f32_scalar_solve_matches_reference(case):
    """Under the f32 policy: f32 scalar payloads, the f64 expanded finest
    operator for the outer CG, and the reference's iterations."""
    rp = case["rp"]
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=COARSE, precision="f32")
    port = _port_setup(ref, precision="f32")
    want = ref_scalar_path.recompute_scalar(ref, rp.A.data)
    hier = scalar_path.recompute_scalar(port, case["a_t"])
    assert all(lv.a_ell.data.dtype == torch.float32 for lv in hier.levels)
    assert hier.a_fine_ell.data.dtype == torch.float64
    np.testing.assert_array_equal(to_np(hier.a_fine_ell.indices),
                                  np.asarray(want.a_fine_ell.indices))
    assert_close(hier.a_fine_ell.data, want.a_fine_ell.data)
    it_ref, x_ref = _ref_solve(ref, want, rp.b)
    res = gamg.hier_solve(port, hier, case["b_t"], rtol=1e-8, maxiter=100)
    assert int(res.iters) == it_ref and bool(res.converged)
    assert rel_err(res.x, x_ref) <= 1e-5


def test_scalar_smoother_matches_reference_recurrence(case):
    """On every scalar level, the port's fused Chebyshev (each step the
    scalar-row smoother's plain version) against the reference's unfused
    recurrence on its scalar level, within 1e-12."""
    want = ref_scalar_path.recompute_scalar(case["ref"],
                                            case["rp"].A.data)
    got = scalar_path.recompute_scalar(case["port"], case["a_t"])
    rng = np.random.default_rng(SEED)
    for gl, wl in zip(got.levels, want.levels):
        n = gl.a_ell.nbr
        b, x = rng.standard_normal(n), rng.standard_normal(n)
        w = ref_chebyshev(wl, jnp.asarray(b), jnp.asarray(x))
        g = chebyshev_smooth_fused(gl, torch.from_numpy(b),
                                   torch.from_numpy(x))
        assert_close(g, w)


def test_scalar_step_plain_version(case):
    """The scalar-row plain step against the blocked plain step on the
    same operator (its blocked ELL), the panel form column by column, and
    the identity-``dinv`` contract ``d' = b - A x``."""
    port = case["port"]
    hb = gamg.recompute(port, case["a_t"])
    hs = scalar_path.recompute_scalar(port, case["a_t"])
    gen = torch.Generator().manual_seed(SEED)
    coef = torch.tensor([0.3, 0.7], dtype=torch.float64)
    for lb, ls in zip(hb.levels, hs.levels):
        nbr, bs = lb.dinv.shape[:2]
        b, x, d = (torch.randn(nbr, bs, generator=gen, dtype=torch.float64)
                   for _ in range(3))
        got = smooth_ops.smoother_step_scalar_ell(
            ls.a_ell.indices, ls.a_ell.data, ls.dinv, b, x, d, coef)
        want = smooth_ops.smoother_step_ell(
            lb.a_ell.indices, lb.a_ell.data, lb.dinv, b, x, d, coef)
        for g, w in zip(got, want):
            assert_close(g, w)
        B, X, D = (torch.randn(nbr, bs, 3, generator=gen,
                               dtype=torch.float64) for _ in range(3))
        xp, dp = smooth_ops.smoother_step_scalar_ell(
            ls.a_ell.indices, ls.a_ell.data, ls.dinv, B, X, D, coef)
        for j in range(3):
            xv, dv = smooth_ops.smoother_step_scalar_ell(
                ls.a_ell.indices, ls.a_ell.data, ls.dinv,
                *(v[:, :, j].contiguous() for v in (B, X, D)), coef)
            assert torch.equal(xp[:, :, j], xv)
            assert torch.equal(dp[:, :, j], dv)
        eye = torch.eye(bs, dtype=torch.float64).expand(nbr, bs, bs)
        _, dn = smooth_ops.smoother_step_scalar_ell(
            ls.a_ell.indices, ls.a_ell.data, eye.contiguous(), b, x, d,
            torch.tensor([0.0, 1.0], dtype=torch.float64))
        res = b.reshape(-1) - spmv_ell(ls.a_ell, x.reshape(-1))
        assert_close(dn.reshape(-1), res)


#: the port's coarsening path (the twin of the reference's list, less its
#: distributed modules, which the port does not have yet)
COARSENING_MODULES = [
    "repro_torch.core.strength", "repro_torch.core.aggregation",
    "repro_torch.core.tentative", "repro_torch.core.smooth",
    "repro_torch.core.gamg", "repro_torch.core.ptap",
    "repro_torch.core.spgemm", "repro_torch.core.block_coo",
    "repro_torch.core.vcycle", "repro_torch.core.krylov",
]


@pytest.mark.parametrize("name", COARSENING_MODULES)
def test_coarsening_modules_do_not_reference_the_expansion(name):
    src = open(importlib.import_module(name).__file__).read()
    assert "scalar_csr" not in src, \
        f"{name} references the scalar expansion module"


def test_setup_and_recompute_never_expand(monkeypatch):
    """A whole setup (both coarseners), hot recomputes and solves with the
    expansion instrumented to fail."""
    def boom(*a, **k):
        raise AssertionError("scalar expansion reached from blocked path")

    monkeypatch.setattr(scalar_csr, "expand_bcsr", boom)
    monkeypatch.setattr(scalar_csr, "expand_structure", boom)
    prob = assemble_elasticity(M, device="cpu")
    for coarsener in ("mis", "greedy"):
        solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=COARSE,
                                 rtol=1e-8, maxiter=50, coarsener=coarsener)
        solver.update_operator(prob.A.data * 1.5)
        assert bool(solver.solve(prob.b).converged)
