"""The reduced-precision policies ("f32", "bf16") of the port against
``repro``: the policy twin, ``REPRO_TORCH_PRECISION``, every kernel
family's plain version at f32 and bf16 against the reference's Pallas
kernel (interpret mode) at the reference's tolerances
(``tests/test_kernels.py``), an f32 hierarchy, and the f32 / bf16 solves,
panel solves and server.  Inputs come from seeded numpy; JAX runs on the
CPU with x64, as the reference's tests run it."""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core import vcycle as ref_vcycle  # noqa: E402
from repro.core.precision import PrecisionPolicy as RefPolicy  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.kernels.block_pair_gemm.block_pair_gemm import (  # noqa: E402
    block_pair_gemm as pl_pair,
)
from repro.kernels.block_seg_sum.ops import block_seg_sum as pl_seg  # noqa
from repro.kernels.block_spmm.block_spmm import block_spmm_ell as pl_spmm  # noqa
from repro.kernels.block_spmv.block_spmv import block_spmv_ell as pl_spmv  # noqa
from repro.kernels.block_spmv.ref import block_spmv_ell_ref as jnp_spmv  # noqa
from repro.kernels.fused_pair_gemm.fused_pair_gemm import (  # noqa: E402
    fused_pair_gemm as pl_gemm,
)
from repro.kernels.fused_smoother.fused_smoother import (  # noqa: E402
    smoother_step_ell as pl_smooth,
)
from repro.kernels.fused_smoother.ref import (  # noqa: E402
    smoother_step_ref as jnp_smooth,
)
from repro.kernels.pbjacobi.pbjacobi import pbjacobi_update as pl_pbj  # noqa

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core import vcycle  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy, \
    setup_from_numpy  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.block_pair_gemm import ops as pair_ops  # noqa
from repro_torch.kernels.block_seg_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.pbjacobi import ops as pbj_ops  # noqa: E402
from repro_torch.multirhs import AMGSolveServer  # noqa: E402

from torch_helpers import _ell_dict, hierarchy_to_numpy, rel_err, \
    setup_to_numpy  # noqa: E402

RNG = np.random.default_rng(20)
# (payload name, numpy dtype, torch dtype, accumulator knob, tolerance):
# the reference's sweep rows below f64 (tests/test_kernels.py:34-48)
DTYPES = [("f32", np.float32, torch.float32, None, 2e-5),
          ("bf16", ml_dtypes.bfloat16, torch.bfloat16, np.float32, 5e-2)]
DTYPE_IDS = [d[0] for d in DTYPES]
BLOCKS = [(3, 3), (3, 6), (6, 6)]
PRODUCTS = [(3, 3, 6), (6, 3, 6), (6, 6, 6)]
VCYCLE_F32 = 2e-5      # a V-cycle on the same f32 hierarchy
SOLUTION = 1e-6        # reduced-precision solves, port against reference


def _pair(a, np_dt):
    """``a`` (float64 numpy) rounded to ``np_dt``, as a jnp array for the
    reference and a torch tensor (the same bits) for the port."""
    arr = np.asarray(a).astype(np_dt)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return jnp.asarray(arr), t


def _acc(accum):
    return None if accum is None else torch.float32


def _close(got, want, tol):
    got = got.double().numpy() if hasattr(got, "double") else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# The policy twin and its resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f64", "f32", "bf16"])
def test_policy_matches_reference_field_by_field(name):
    got, want = PrecisionPolicy.from_name(name), RefPolicy.from_name(name)
    for field in ("hierarchy_dtype", "smoother_dtype", "krylov_dtype",
                  "accum_dtype", "factor_dtype"):
        assert str(getattr(got, field)).removeprefix("torch.") == \
            getattr(want, field).name, field
    assert got.mixed == want.mixed
    k_got, k_want = got.kernel_accum_dtype, want.kernel_accum_dtype
    assert (k_got is None) == (k_want is None)
    if k_want is not None:
        assert str(k_got).removeprefix("torch.") == np.dtype(k_want).name
    assert got.coarse_jitter_scale() == want.coarse_jitter_scale()
    assert got.coarse_retry_scale() == want.coarse_retry_scale()
    assert got.describe() == want.describe()


def test_policy_aliases_and_invalid_names():
    for alias, stock in (("fp64", "f64"), ("float64", "f64"),
                         ("double", "f64"), ("fp32", "f32"),
                         ("float32", "f32"), ("single", "f32"),
                         ("bfloat16", "bf16"), (" BF16 ", "bf16")):
        assert PrecisionPolicy.from_name(alias) == \
            PrecisionPolicy.from_name(stock)
        assert RefPolicy.from_name(alias) == RefPolicy.from_name(stock)
    for bad in ("f16", "half", 32):
        with pytest.raises(ValueError):
            PrecisionPolicy.from_name(bad)
        with pytest.raises(ValueError):
            RefPolicy.from_name(bad)


def test_resolve_precision_reads_the_ports_variable(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PRECISION", raising=False)
    monkeypatch.setenv("REPRO_PRECISION", "bf16")     # the reference's
    assert backend.resolve_precision() == PrecisionPolicy.double()
    monkeypatch.setenv("REPRO_TORCH_PRECISION", "f32")
    assert backend.resolve_precision() == PrecisionPolicy.from_name("f32")
    assert backend.resolve_precision("bf16").hierarchy_dtype == \
        torch.bfloat16
    pol = PrecisionPolicy.from_name("bf16")
    assert backend.resolve_precision(pol) is pol
    monkeypatch.setenv("REPRO_TORCH_PRECISION", "f16")
    with pytest.raises(ValueError, match="REPRO_TORCH_PRECISION"):
        backend.resolve_precision()


def test_kernel_entry_points_by_payload_and_accumulator():
    e = backend.entry
    assert e("block_spmv", torch.float64) == "repro_block_spmv_f64"
    assert e("block_spmv", torch.float32) == "repro_block_spmv_f32"
    assert e("block_spmv", torch.bfloat16) == "repro_block_spmv_bf16"
    assert e("block_spmv", torch.bfloat16, torch.float32) == \
        "repro_block_spmv_bf16"
    assert e("pbjacobi", torch.bfloat16, "float32", bf16_f32=True) == \
        "repro_pbjacobi_bf16_f32"
    for dt, acc in ((torch.float64, torch.float32),
                    (torch.float32, torch.float64), (torch.float16, None)):
        with pytest.raises(ValueError, match="instantiation"):
            e("block_spmv", dt, acc)
    with pytest.raises(ValueError, match="one payload dtype"):
        backend.check_kernel_args("k", dict(a=torch.zeros(2),
                                            b=torch.zeros(2).double()))


# ---------------------------------------------------------------------------
# Plain versions against the reference's Pallas kernels, f32 and bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,np_dt,t_dt,accum,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("br,bc", BLOCKS)
def test_spmv_and_spmm_plain_match_pallas(br, bc, name, np_dt, t_dt, accum,
                                          tol):
    nbr, kmax, k = 16, 7, 4
    idx = RNG.integers(0, nbr + 3, (nbr, kmax)).astype(np.int32)
    data = RNG.standard_normal((nbr, kmax, br, bc))
    x = RNG.standard_normal((nbr + 3, bc))
    X = RNG.standard_normal((nbr + 3, bc, k))
    (jd, td), (jx, tx), (jX, tX) = (_pair(a, np_dt) for a in (data, x, X))
    ti = torch.from_numpy(idx)
    got = spmv_ops.block_spmv_ell(ti, td, tx, accum_dtype=_acc(accum))
    assert got.dtype == t_dt
    _close(got, pl_spmv(jnp.asarray(idx), jd, jx, interpret=True,
                        accum_dtype=accum), tol)
    got = spmm_ops.block_spmm_ell(ti, td, tX, accum_dtype=_acc(accum))
    assert got.dtype == t_dt
    _close(got, pl_spmm(jnp.asarray(idx), jd, jX, interpret=True,
                        accum_dtype=accum), tol)


@pytest.mark.parametrize("name,np_dt,t_dt,accum,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("br,bk,bc", PRODUCTS)
def test_pair_gemms_plain_match_pallas(br, bk, bc, name, np_dt, t_dt, accum,
                                       tol):
    npairs, na, nb, rows, kmax = 130, 11, 13, 9, 5
    (jl, tl), (jr, tr) = (_pair(RNG.standard_normal(s), np_dt) for s in
                          ((npairs, br, bk), (npairs, bk, bc)))
    got = pair_ops.block_pair_gemm(tl, tr, accum_dtype=_acc(accum))
    assert got.dtype == t_dt
    _close(got, pl_pair(jl, jr, interpret=True, accum_dtype=accum), tol)
    # the fused product: operands gathered through a tile plan
    (ja, ta), (jb, tb) = (_pair(RNG.standard_normal(s), np_dt) for s in
                          ((na, br, bk), (nb, bk, bc)))
    tile_a = RNG.integers(0, na, (rows, kmax)).astype(np.int32)
    tile_b = RNG.integers(0, nb, (rows, kmax)).astype(np.int32)
    mask = RNG.random((rows, kmax)) < 0.8
    got = gemm_ops.fused_pair_gemm(ta, tb, torch.from_numpy(tile_a),
                                   torch.from_numpy(tile_b),
                                   torch.from_numpy(mask),
                                   accum_dtype=_acc(accum))
    assert got.dtype == t_dt
    lhs = jnp.where(jnp.asarray(mask)[..., None, None], ja[tile_a], 0)
    _close(got, pl_gemm(lhs, jb[tile_b], interpret=True,
                        accum_dtype=accum), tol)


@pytest.mark.parametrize("name,np_dt,t_dt,accum,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("br,bc", BLOCKS)
def test_seg_sum_plain_matches_pallas(br, bc, name, np_dt, t_dt, accum,
                                      tol):
    n, nseg = 100, 23
    ids = np.sort(RNG.integers(0, nseg, n)).astype(np.int32)
    offsets = np.zeros(nseg + 1, np.int32)
    np.cumsum(np.bincount(ids, minlength=nseg), out=offsets[1:])
    jv, tv = _pair(RNG.standard_normal((n, br, bc)), np_dt)
    # the port sums a bf16 stream at an f32 accumulator, which it names
    got = seg_ops.block_seg_sum(tv, torch.from_numpy(offsets),
                                accum_dtype=torch.float32)
    assert got.dtype == t_dt
    _close(got, pl_seg(jv, jnp.asarray(ids), nseg, interpret=True,
                       accum_dtype=np.float32), tol)


@pytest.mark.parametrize("name,np_dt,t_dt,accum,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("bs", [3, 6])
def test_pbjacobi_and_smoother_plain_match_pallas(bs, name, np_dt, t_dt,
                                                  accum, tol):
    nbr, kmax, k = 17, 5, 3
    idx = RNG.integers(0, nbr, (nbr, kmax)).astype(np.int32)
    (jd, td), (jdi, tdi), (jr, tr), (jx, tx) = (
        _pair(RNG.standard_normal(s), np_dt) for s in
        ((nbr, kmax, bs, bs), (nbr, bs, bs), (nbr, bs), (nbr, bs)))
    got = pbj_ops.pbjacobi_update(tdi, tr, tx, 0.7, accum_dtype=_acc(accum))
    assert got.dtype == t_dt
    _close(got, pl_pbj(jdi, jr, jx, jnp.asarray(0.7), interpret=True,
                       accum_dtype=accum), tol)
    jc, tc = _pair(np.array([0.3, 0.7]), np_dt)
    for cols in ((), (k,)):
        (jb, tb), (jxx, txx), (jdd, tdd) = (
            _pair(RNG.standard_normal((nbr, bs) + cols), np_dt)
            for _ in range(3))
        got = smooth_ops.smoother_step_ell(torch.from_numpy(idx), td, tdi,
                                           tb, txx, tdd, tc,
                                           accum_dtype=_acc(accum))
        want = pl_smooth(jnp.asarray(idx), jd, jdi, jb, jxx, jdd, jc,
                         interpret=True, accum_dtype=accum)
        for g, w in zip(got, want):
            assert g.dtype == t_dt
            _close(g, w, tol)


@pytest.mark.parametrize("bs", [3, 6])
def test_bf16_native_accumulator_matches_reference_oracles(bs):
    """acc = bf16 (the bf16 V-cycle's, ``accum_dtype=None``): each
    contraction sums at f32 and rounds once to bf16, each elementwise step
    rounds to bf16 — against the reference's jnp oracles at bf16."""
    nbr, kmax = 17, 5
    idx = RNG.integers(0, nbr, (nbr, kmax)).astype(np.int32)
    bf = ml_dtypes.bfloat16
    (jd, td), (jdi, tdi), (jb, tb), (jx, tx), (jdd, tdd) = (
        _pair(RNG.standard_normal(s), bf) for s in
        ((nbr, kmax, bs, bs), (nbr, bs, bs), (nbr, bs), (nbr, bs),
         (nbr, bs)))
    jc, tc = _pair(np.array([0.3, 0.7]), bf)
    ti = torch.from_numpy(idx)
    _close(spmv_ops.block_spmv_ell(ti, td, tx),
           jnp_spmv(jnp.asarray(idx), jd, jx), 5e-2)
    got = smooth_ops.smoother_step_ell(ti, td, tdi, tb, tx, tdd, tc)
    want = jnp_smooth(jnp.asarray(idx), jd, jdi, jb, jx, jdd, jc)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, 5e-2)


# ---------------------------------------------------------------------------
# Hierarchies and solves
# ---------------------------------------------------------------------------

def _port_solver(m, coarse_size, precision):
    prob = assemble_elasticity(m, path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=coarse_size,
                             coarsener="greedy", precision=precision)
    return prob, solver


@pytest.fixture(scope="module")
def m6():
    """m=6 (coarse_size 100, greedy): the reference's f32 and bf16 solvers
    and the port's f64 and f32 solvers."""
    rprob = ref_assemble(6, path="host")
    ref = {p: ref_gamg.GAMGSolver(rprob.A, rprob.B, coarse_size=100,
                                  coarsener="greedy", precision=p)
           for p in ("f32", "bf16")}
    prob, s64 = _port_solver(6, 100, "f64")
    _, s32 = _port_solver(6, 100, "f32")
    return dict(rprob=rprob, ref=ref, prob=prob, s64=s64, s32=s32)


def test_f32_hierarchy_matches_f64_structure_and_reference_vcycle(m6):
    s64, s32 = m6["s64"], m6["s32"]
    d64, d32 = s64.setup_data, s32.setup_data
    assert d32.stats["level_rows"] == d64.stats["level_rows"] == [540, 66]
    for l64, l32 in zip(d64.levels, d32.levels):
        np.testing.assert_array_equal(l32.aggr.node_to_agg,
                                      l64.aggr.node_to_agg)
        assert torch.equal(l32.P.data, l64.P.data)
    h = s32.hierarchy
    for lv in h.levels:
        for t in (lv.a_ell.data, lv.p_ell.data, lv.dinv, lv.lam_max):
            assert t.dtype == torch.float32
    assert h.coarse_chol.dtype == torch.float32
    assert h.a_fine_ell.data.dtype == torch.float64
    assert torch.equal(h.a_fine_ell.data, s64.hierarchy.levels[0].a_ell.data)
    assert s64.hierarchy.a_fine_ell is None
    # a V-cycle on the reference's f32 hierarchy, carried by interop with
    # its f64 Krylov operator, and the outer solve on it
    ref = m6["ref"]["f32"]
    levels, chol = hierarchy_to_numpy(ref.hierarchy)
    hier = hierarchy_from_numpy(levels, chol, device="cpu",
                                a_fine_ell=_ell_dict(ref.hierarchy.a_fine_ell))
    assert hier.levels[0].a_ell.data.dtype == torch.float32
    assert vcycle.fine_operator(hier).data.dtype == torch.float64
    b = RNG.standard_normal(m6["prob"].n).astype(np.float32)
    want = ref_vcycle.vcycle(ref.hierarchy, jnp.asarray(b))
    got = vcycle.vcycle(hier, torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= VCYCLE_F32
    want = ref.solve(m6["rprob"].b)
    got = gamg.hier_solve(s32.setup_data, hier, m6["prob"].b)
    assert got.iters == int(want.iters)
    assert rel_err(got.x, want.x) <= SOLUTION


def test_interop_setup_carries_the_policy(m6):
    levels, coarse = setup_to_numpy(m6["ref"]["f32"].setup_data)
    s = setup_from_numpy(levels, coarse, coarsener="greedy",
                         precision="f32", device="cpu")
    assert s.precision == PrecisionPolicy.from_name("f32")
    assert s.levels[0].A0.data.dtype == torch.float64
    hier = gamg.recompute(s, s.levels[0].A0.data)
    assert hier.levels[0].a_ell.data.dtype == torch.float32
    assert hier.a_fine_ell.data.dtype == torch.float64


@pytest.fixture(scope="module", params=[(6, 100), (7, 12)],
                ids=["m6-cs100", "m7-cs12"])
def ref_f32(request):
    """The reference's f32 solve (its CPU default smoother path)."""
    m, coarse_size = request.param
    rprob = ref_assemble(m, path="host")
    ref = ref_gamg.GAMGSolver(rprob.A, rprob.B, coarse_size=coarse_size,
                              coarsener="greedy", precision="f32")
    return m, coarse_size, ref.solve(rprob.b)


@pytest.mark.parametrize("path", ["fused", "reference"])
def test_f32_solve_matches_reference(ref_f32, path, monkeypatch):
    m, coarse_size, want = ref_f32
    monkeypatch.setenv("REPRO_TORCH_SMOOTH_PATH", path)
    prob, solver = _port_solver(m, coarse_size, "f32")
    got = solver.solve(prob.b)
    assert got.x.dtype == torch.float64
    assert got.iters == int(want.iters)
    assert float(got.relres) <= 1e-8
    assert rel_err(got.x, want.x) <= SOLUTION


def test_bf16_solve_matches_reference(m6):
    want = m6["ref"]["bf16"].solve(m6["rprob"].b)
    prob, solver = _port_solver(6, 100, "bf16")
    h = solver.hierarchy
    assert h.levels[0].a_ell.data.dtype == torch.bfloat16
    assert h.coarse_chol.dtype == torch.bfloat16
    assert h.a_fine_ell.data.dtype == torch.float64
    got = solver.solve(prob.b)
    assert bool(got.converged) == bool(want.converged)
    assert abs(got.iters - int(want.iters)) <= 2


def test_bf16_coarse_breakdown_matches_reference():
    """At m=16 (coarse_size 100, greedy) the bf16 PtAP chain leaves a
    coarse operator that no jitter of the policy makes positive definite:
    the reference's coarse factor is NaN and its solve stops at once,
    non-finite — and so does the port's (the m=32 bf16 run on the card
    ends the same way)."""
    rprob = ref_assemble(16, path="host")
    ref = ref_gamg.GAMGSolver(rprob.A, rprob.B, coarse_size=100,
                              coarsener="greedy", precision="bf16")
    want = ref.solve(rprob.b)
    prob, solver = _port_solver(16, 100, "bf16")
    got = solver.solve(prob.b)
    assert solver.setup_data.stats["level_rows"] == \
        ref.setup_data.stats["level_rows"]
    assert not np.isfinite(np.asarray(ref.hierarchy.coarse_chol,
                                      np.float32)).all()
    assert not bool(torch.isfinite(solver.hierarchy.coarse_chol.float())
                    .all())
    assert not bool(want.converged) and not bool(got.converged)
    assert got.iters == int(want.iters)
    assert int(got.health.status) == int(want.health.status)


def test_f32_solve_many_and_server(m6):
    prob, s32 = m6["prob"], m6["s32"]
    B = torch.stack([prob.b] + [torch.from_numpy(RNG.standard_normal(
        prob.n)) for _ in range(2)], dim=1)
    res = s32.solve_many(B)
    assert res.x.dtype == torch.float64
    assert bool(res.converged.all())
    for j in range(B.shape[1]):
        single = s32.solve(B[:, j].contiguous())
        assert abs(int(res.iters[j]) - single.iters) <= 2
    srv = AMGSolveServer(s32.setup_data, prob.A.data.numpy(),
                         buckets=(1, 2, 4), rtol=1e-8, maxiter=100)
    fine = srv.hierarchy.a_fine_ell.data
    assert fine.dtype == torch.float64
    assert torch.equal(fine, s32.setup_data.levels[0].a_ell_plan.build(
        prob.A.data).data)
    assert srv.hierarchy.levels[0].a_ell.data.dtype == torch.float32
    rhs = [prob.b.numpy(), RNG.standard_normal(prob.n)]
    reports = srv.serve(rhs)
    assert all(r.converged for r in reports)
    for rep, b in zip(reports, rhs):
        single = s32.solve(torch.as_tensor(b))
        assert abs(rep.iters - single.iters) <= 2
        assert rel_err(rep.x, single.x) <= SOLUTION
