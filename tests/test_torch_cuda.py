"""The port's CUDA kernels on the card: each wrapper against its plain
version at small main-path block shapes, its launch counter, and the port
on the card against the port on the CPU.  Marked ``cuda``; skipped where
no CUDA device is present.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gamg import GAMGSolver  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.kernels.block_pair_gemm import ops as pair_ops  # noqa
from repro_torch.kernels.block_pair_gemm.ref import \
    block_pair_gemm_ref  # noqa: E402
from repro_torch.kernels.block_seg_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref  # noqa
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref  # noqa
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref  # noqa
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops  # noqa
from repro_torch.kernels.fused_pair_gemm.ref import \
    fused_pair_gemm_ref  # noqa: E402
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.fused_smoother.ref import \
    smoother_step_ref  # noqa: E402
from repro_torch.kernels import autotune, backend  # noqa: E402
from repro_torch.kernels.pbjacobi import ops as pbj_ops  # noqa: E402
from repro_torch.kernels.pbjacobi.ref import pbjacobi_update_ref  # noqa

pytestmark = pytest.mark.cuda
REL = 1e-12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    got = torch.cat([g.reshape(-1) for g in got]) if isinstance(
        got, tuple) else got
    want = torch.cat([w.reshape(-1) for w in want]) if isinstance(
        want, tuple) else want
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


def _launch_once(mod, call):
    before = mod.launches
    out = call()
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    return out


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 6)])
def test_seg_sum_kernel(dev, br, bc):
    g = torch.Generator(device=dev).manual_seed(br * bc)
    vals = torch.randn(300, br, bc, generator=g, dtype=torch.float64,
                       device=dev)
    cuts = torch.randint(0, 301, (49,), generator=g, device=dev).sort()[0]
    ends = torch.tensor([0, 300], device=dev)
    offsets = torch.cat([ends[:1], cuts, ends[1:]]).to(torch.int32)
    perm = torch.randperm(300, generator=g, device=dev).to(torch.int32)
    got = _launch_once(seg_ops, lambda: seg_ops.block_seg_sum(
        vals, offsets, perm))
    assert torch.equal(got, block_seg_sum_ref(vals, offsets, perm))


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 6)])
def test_spmv_kernel(dev, br, bc):
    g = torch.Generator(device=dev).manual_seed(10 + br * bc)
    idx = torch.randint(0, 40, (70, 9), generator=g, device=dev,
                        dtype=torch.int32)
    data = torch.randn(70, 9, br, bc, generator=g, dtype=torch.float64,
                       device=dev)
    x = torch.randn(40, bc, generator=g, dtype=torch.float64, device=dev)
    got = _launch_once(spmv_ops, lambda: spmv_ops.block_spmv_ell(
        idx, data, x))
    _close(got, block_spmv_ell_ref(idx, data, x))


@pytest.mark.parametrize("bs", [3, 6])
def test_smoother_kernel(dev, bs):
    g = torch.Generator(device=dev).manual_seed(20 + bs)
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.randint(0, 60, (60, 7), generator=g, device=dev,
                        dtype=torch.int32)
    args = (idx, torch.randn(60, 7, bs, bs, generator=g, **f64),
            torch.randn(60, bs, bs, generator=g, **f64)) + tuple(
        torch.randn(60, bs, generator=g, **f64) for _ in range(3)) + (
        torch.tensor([0.25, 0.8], **f64),)
    got = _launch_once(smooth_ops,
                       lambda: smooth_ops.smoother_step_ell(*args))
    _close(got, smoother_step_ref(*args))


@pytest.mark.parametrize("br,bk,bc", [(3, 3, 6), (6, 3, 6), (6, 6, 6)])
def test_pair_gemm_kernel(dev, br, bk, bc):
    g = torch.Generator(device=dev).manual_seed(30 + br + bk + bc)
    f64 = dict(dtype=torch.float64, device=dev)
    a = torch.randn(50, br, bk, generator=g, **f64)
    b = torch.randn(45, bk, bc, generator=g, **f64)
    ta = torch.randint(0, 50, (80, 6), generator=g, device=dev,
                       dtype=torch.int32)
    tb = torch.randint(0, 45, (80, 6), generator=g, device=dev,
                       dtype=torch.int32)
    mask = torch.rand(80, 6, generator=g, device=dev) < 0.7
    got = _launch_once(gemm_ops, lambda: gemm_ops.fused_pair_gemm(
        a, b, ta, tb, mask))
    _close(got, fused_pair_gemm_ref(a, b, ta, tb, mask))


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 6)])
@pytest.mark.parametrize("k", [2, 5, 16])
def test_spmm_kernel_bitwise_per_column(dev, br, bc, k):
    """Each panel column is bitwise ``block_spmv`` of that column."""
    g = torch.Generator(device=dev).manual_seed(40 + br * bc + k)
    idx = torch.randint(0, 40, (70, 9), generator=g, device=dev,
                        dtype=torch.int32)
    data = torch.randn(70, 9, br, bc, generator=g, dtype=torch.float64,
                       device=dev)
    x = torch.randn(40, bc, k, generator=g, dtype=torch.float64, device=dev)
    got = _launch_once(spmm_ops, lambda: spmm_ops.block_spmm_ell(
        idx, data, x))
    _close(got, block_spmm_ell_ref(idx, data, x))
    for j in range(k):
        col = spmv_ops.block_spmv_ell(idx, data, x[:, :, j].contiguous())
        assert torch.equal(got[:, :, j], col)


@pytest.mark.parametrize("bs", [3, 6])
def test_smoother_panel_kernel_bitwise_per_column(dev, bs):
    g = torch.Generator(device=dev).manual_seed(50 + bs)
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.randint(0, 60, (60, 7), generator=g, device=dev,
                        dtype=torch.int32)
    a, dinv = (torch.randn(60, 7, bs, bs, generator=g, **f64),
               torch.randn(60, bs, bs, generator=g, **f64))
    b, x, d = (torch.randn(60, bs, 6, generator=g, **f64) for _ in range(3))
    coef = torch.tensor([0.25, 0.8], **f64)
    args = (idx, a, dinv, b, x, d, coef)
    got = _launch_once(smooth_ops,
                       lambda: smooth_ops.smoother_step_ell(*args))
    _close(got, smoother_step_ref(*args))
    for j in range(6):
        xj, dj = smooth_ops.smoother_step_ell(
            idx, a, dinv, *(v[:, :, j].contiguous() for v in (b, x, d)),
            coef)
        assert torch.equal(got[0][:, :, j], xj)
        assert torch.equal(got[1][:, :, j], dj)


@pytest.mark.parametrize("br,bk,bc", [(3, 3, 6), (6, 3, 6), (6, 6, 6)])
def test_block_pair_gemm_kernel(dev, br, bk, bc):
    g = torch.Generator(device=dev).manual_seed(60 + br + bk + bc)
    f64 = dict(dtype=torch.float64, device=dev)
    lhs = torch.randn(1000, br, bk, generator=g, **f64)
    rhs = torch.randn(1000, bk, bc, generator=g, **f64)
    got = _launch_once(pair_ops, lambda: pair_ops.block_pair_gemm(lhs, rhs))
    _close(got, block_pair_gemm_ref(lhs, rhs))


def test_empty_panel_raises(dev):
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    data = torch.zeros((4, 2, 3, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="k >= 1"):
        spmm_ops.block_spmm_ell(idx, data, torch.zeros(
            (1, 3, 0), dtype=torch.float64, device=dev))


def test_panel_solve_on_card_matches_cpu_and_vector(dev):
    """``solve_many`` on the card: per-column iterations equal the CPU
    panel and the card's vector solves; a width-1 panel is bitwise the
    vector apply."""
    B_host = None
    runs = {}
    for d in ("cpu", dev):
        prob = assemble_elasticity(7, device=d)
        solver = GAMGSolver(prob.A, prob.B, coarse_size=12)
        if B_host is None:
            B_host = np.random.default_rng(7).standard_normal((prob.n, 4))
        B = torch.as_tensor(B_host).to(d)
        runs[str(d)] = (solver, B, solver.solve_many(B))
    (_, _, r_cpu), (solver, B, r_gpu) = runs.values()
    assert torch.equal(r_cpu.iters, r_gpu.iters.cpu())
    x_cpu, x_gpu = r_cpu.x, r_gpu.x.cpu()
    assert float((x_cpu - x_gpu).norm() / x_cpu.norm()) <= 1e-9
    for j in range(4):
        v = solver.solve(B[:, j].contiguous())
        assert v.iters == int(r_gpu.iters[j])
    from repro_torch.core.spmv import apply_ell
    a = solver.hierarchy.levels[0].a_ell
    assert torch.equal(apply_ell(a, B[:, :1].contiguous())[:, 0],
                       apply_ell(a, B[:, 0].contiguous()))


def test_pairs_path_matches_fused_on_card(dev, monkeypatch):
    prob = assemble_elasticity(7, device=dev)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=12)
    a = prob.reassemble(1.2).data
    solver.update_operator(a)
    fused = solver.hierarchy
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "pairs")
    before = pair_ops.launches
    solver.update_operator(a)
    assert pair_ops.launches > before
    for f, p in zip(fused.levels, solver.hierarchy.levels):
        _close(p.a_ell.data, f.a_ell.data)
        _close(p.dinv, f.dinv)
    _close(solver.hierarchy.coarse_chol, fused.coarse_chol)


def test_unsupported_block_shape_raises(dev):
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    data = torch.zeros((4, 2, 2, 2), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        spmv_ops.block_spmv_ell(idx, data, torch.zeros(
            (1, 2), dtype=torch.float64, device=dev))


def test_port_on_card_matches_port_on_cpu(dev):
    runs = {}
    for d in ("cpu", dev):
        prob = assemble_elasticity(7, device=d)
        solver = GAMGSolver(prob.A, prob.B, coarse_size=12)
        res = solver.solve(prob.b)
        runs[str(d)] = (solver.setup_data, res)
    (s_cpu, r_cpu), (s_gpu, r_gpu) = runs.values()
    assert s_cpu.stats["level_rows"] == s_gpu.stats["level_rows"]
    for a, b in zip(s_cpu.levels, s_gpu.levels):
        np.testing.assert_array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg)
    assert r_cpu.iters == r_gpu.iters
    x_cpu, x_gpu = r_cpu.x, r_gpu.x.cpu()
    assert float((x_cpu - x_gpu).norm() / x_cpu.norm()) <= 1e-9


def test_reference_paths_refuse_cuda_payloads(dev):
    """The plain 'reference' paths never run on the card."""
    from repro_torch.core.vcycle import apply_smoother
    prob = assemble_elasticity(4, device=dev)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=12)
    cache = solver.setup_data.levels[0].ptap_cache
    with pytest.raises(ValueError, match="CPU-only"):
        from repro_torch.core.spgemm import spgemm_numeric_data
        spgemm_numeric_data(cache.ap_plan, prob.A.data,
                            solver.setup_data.levels[0].P.data,
                            path="reference")
    lv = solver.hierarchy.levels[0]
    with pytest.raises(ValueError, match="CPU-only"):
        apply_smoother(lv, prob.b, torch.zeros_like(prob.b), "chebyshev", 2,
                       path="reference")


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("nbr", [37, 1000])
def test_pbjacobi_kernel(dev, bs, nbr):
    g = torch.Generator(device=dev).manual_seed(70 + bs + nbr)
    f64 = dict(dtype=torch.float64, device=dev)
    dinv = torch.randn(nbr, bs, bs, generator=g, **f64)
    r, x = (torch.randn(nbr, bs, generator=g, **f64) for _ in range(2))
    got = _launch_once(pbj_ops, lambda: pbj_ops.pbjacobi_update(
        dinv, r, x, 0.7))
    _close(got, pbjacobi_update_ref(dinv, r, x, 0.7))
    w = torch.tensor([0.7], **f64)
    assert torch.equal(_launch_once(pbj_ops, lambda: pbj_ops.pbjacobi_update(
        dinv, r, x, w)), got)


def _tuned_calls(dev):
    """One small launch of each tuned family, taking ``threads``."""
    g = torch.Generator(device=dev).manual_seed(80)
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.randint(0, 300, (700, 9), generator=g, device=dev,
                        dtype=torch.int32)
    a66 = torch.randn(700, 9, 6, 6, generator=g, **f64)
    x = torch.randn(300, 6, generator=g, **f64)
    X = torch.randn(300, 6, 5, generator=g, **f64)
    sm = (idx, a66, torch.randn(700, 6, 6, generator=g, **f64)) + tuple(
        torch.randn(700, 6, 3, generator=g, **f64) for _ in range(3)) + (
        torch.tensor([0.25, 0.8], **f64),)
    ga = torch.randn(300, 6, 3, generator=g, **f64)
    gb = torch.randn(300, 3, 6, generator=g, **f64)
    mask = torch.rand(700, 9, generator=g, device=dev) < 0.7
    dinv = torch.randn(700, 6, 6, generator=g, **f64)
    r, xv = (torch.randn(700 * 6, generator=g, **f64) for _ in range(2))
    return {
        "block_spmv": lambda t: spmv_ops.block_spmv_ell(idx, a66, x,
                                                        threads=t),
        "block_spmm": lambda t: spmm_ops.block_spmm_ell(idx, a66, X,
                                                        threads=t),
        "fused_smoother": lambda t: smooth_ops.smoother_step_ell(
            *sm, threads=t),
        "fused_pair_gemm": lambda t: gemm_ops.fused_pair_gemm(
            ga, gb, idx, idx, mask, threads=t),
        "pbjacobi": lambda t: pbj_ops.pbjacobi_apply(dinv, r, xv, 0.6,
                                                     threads=t),
    }


@pytest.mark.parametrize("family", sorted(autotune.CANDIDATES))
def test_threads_candidates_bitwise(dev, family):
    """The block size changes nothing but speed: every candidate is
    bitwise the 256-thread launch."""
    call = _tuned_calls(dev)[family]
    want = call(autotune.DEFAULT_THREADS)
    want = want if isinstance(want, tuple) else (want,)
    for t in autotune.CANDIDATES[family]["threads"]:
        got = call(t)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), t


@pytest.mark.parametrize("threads", [48, 2048])
def test_invalid_threads_raise(dev, threads):
    with pytest.raises(ValueError, match="multiple of 32"):
        _tuned_calls(dev)["block_spmv"](threads)
    # the C entry points refuse it as well (cudaErrorInvalidValue)
    f64 = dict(dtype=torch.float64, device=dev)
    dinv = torch.zeros(4, 3, 3, **f64)
    r = torch.zeros(4, 3, **f64)
    w = torch.ones(1, **f64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        p = backend.ptr
        backend.launch("repro_pbjacobi_f64", pbj_ops._ARGS, p(dinv), p(r),
                       p(r), p(w), p(torch.empty_like(r)), 4, 3, threads)


#: ragged (nbr, kmax, br, bc): kmax not a multiple of the lanes, kmax
#: below them, kmax 1 and 490 (A2's width), nbr not a multiple of the
#: rows per block, nbr 1
RAGGED = [(37, 7, 3, 3), (5, 3, 6, 6), (70, 27, 3, 3), (1, 1, 3, 6),
          (9, 490, 6, 6), (1, 490, 6, 6), (33, 19, 6, 6), (1, 5, 3, 3)]
LANES = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("nbr,kmax,br,bc", RAGGED)
def test_lanes_kernels_at_ragged_shapes(dev, nbr, kmax, br, bc):
    """Every lanes value at ragged shapes: against the plain versions,
    every ``threads`` candidate bitwise the 256-thread launch, and each
    panel column bitwise the vector launch with the same lanes."""
    g = torch.Generator(device=dev).manual_seed(90 + nbr + kmax + br * bc)
    f64 = dict(dtype=torch.float64, device=dev)
    nbc = 23
    idx = torch.randint(0, nbc, (nbr, kmax), generator=g, device=dev,
                        dtype=torch.int32)
    data = torch.randn(nbr, kmax, br, bc, generator=g, **f64)
    x = torch.randn(nbc, bc, generator=g, **f64)
    panels = [torch.randn(nbc, bc, k, generator=g, **f64)
              for k in (3, 9, 16)]
    spmv, spmm = spmv_ops.launch_lanes, spmm_ops.launch_lanes
    # 1024 threads: block_spmm's build limited to 64 registers a thread
    threads = autotune.CANDIDATES["block_spmv"]["threads"] + (1024,)
    for lanes in LANES:
        y = spmv(idx, data, x, lanes, 256)
        _close(y, block_spmv_ell_ref(idx, data, x))
        for X in panels:
            Y = spmm(idx, data, X, lanes, 256)
            _close(Y, block_spmm_ell_ref(idx, data, X))
            for j in range(X.shape[2]):
                assert torch.equal(Y[:, :, j], spmv(
                    idx, data, X[:, :, j].contiguous(), lanes, 256)), \
                    (lanes, X.shape[2], j)
            for t in threads:
                assert torch.equal(spmm(idx, data, X, lanes, t), Y)
        for t in threads:
            assert torch.equal(spmv(idx, data, x, lanes, t), y)
    torch.cuda.synchronize()


def test_wrappers_launch_the_lanes_map(dev):
    """The wrappers' launches are the explicit launches at
    ``ell_rows.lanes(br, bc, kmax)``."""
    from repro_torch.kernels import ell_rows
    g = torch.Generator(device=dev).manual_seed(95)
    f64 = dict(dtype=torch.float64, device=dev)
    for kmax, br, bc in ((27, 3, 3), (8, 3, 6), (45, 6, 6), (490, 6, 6)):
        idx = torch.randint(0, 50, (60, kmax), generator=g, device=dev,
                            dtype=torch.int32)
        data = torch.randn(60, kmax, br, bc, generator=g, **f64)
        x = torch.randn(50, bc, generator=g, **f64)
        X = torch.randn(50, bc, 4, generator=g, **f64)
        lanes = ell_rows.lanes(br, bc, kmax)
        assert torch.equal(spmv_ops.block_spmv_ell(idx, data, x),
                           spmv_ops.launch_lanes(idx, data, x, lanes, 256))
        assert torch.equal(spmm_ops.block_spmm_ell(idx, data, X),
                           spmm_ops.launch_lanes(idx, data, X, lanes, 256))


@pytest.mark.parametrize("lanes", [0, 3, 12, 64, -4])
def test_c_entries_refuse_bad_lanes(dev, lanes):
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    data = torch.zeros((4, 2, 3, 3), **f64)
    x, X = torch.zeros((1, 3), **f64), torch.zeros((1, 3, 2), **f64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmv_ops.launch_lanes(idx, data, x, lanes, 256)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmm_ops.launch_lanes(idx, data, X, lanes, 256)


def test_c_entries_refuse_misaligned_even_width_payloads(dev):
    """Even-width blocks are read in 16-byte pairs."""
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    data = torch.zeros(1 + 4 * 2 * 18, **f64)[1:].view(4, 2, 3, 6)
    x, X = torch.zeros((1, 6), **f64), torch.zeros((1, 6, 2), **f64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmv_ops.launch_lanes(idx, data, x, 4, 256)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmm_ops.launch_lanes(idx, data, X, 4, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        spmv_ops.block_spmv_ell(idx, data, x)


#: signatures whose winners, picked by the host clock, lost to the static
#: 256 by CUDA events (PERF.md), and the level-2 vector launches
SWEPT = [
    ("block_spmv", dict(br=6, bc=6, kmax=490), 836),
    ("block_spmm", dict(br=6, bc=6, kmax=490, k=16), 836 * 16),
    ("block_spmm", dict(br=6, bc=6, kmax=45, k=16), 1331 * 16),
    ("fused_smoother", dict(br=6, bc=6, kmax=490, k=16), 836 * 16),
    ("fused_smoother", dict(br=6, bc=6, kmax=490), 836),
    ("pbjacobi", dict(bs=6), 1331 * 6),
    ("pbjacobi", dict(bs=6), 836 * 6),
]


@pytest.mark.parametrize("family,keys,items", SWEPT)
def test_no_cached_winner_is_slower_than_the_static_launch(
        dev, tmp_path, monkeypatch, family, keys, items):
    """The sweep scores by CUDA events and keeps 256 unless a candidate
    beats it by more than ``EVENT_MARGIN``: timed again in turns, no
    winner is slower than 256 beyond that margin."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    autotune.clear_memo()
    sig = autotune.signature(torch.float64, items, **keys)
    won = autotune.sweep(family, sig, device=dev)
    t = won["params"]["threads"]
    assert autotune.lookup(family, sig, "threads", dev) == t
    assert t == autotune.DEFAULT_THREADS or won["best_us"] < \
        won["table"]["threads=256"] * (1 - autotune.EVENT_MARGIN)
    ops = autotune._synthetic(family, sig, autotune._rows(family, sig), dev)
    static = autotune._make_runner(family, {"threads": 256}, ops)
    tuned = autotune._make_runner(family, {"threads": t}, ops)
    s1, t1, t2, s2 = (autotune.device_ms(f) for f in (static, tuned, tuned,
                                                      static))
    assert (t1 + t2) <= (s1 + s2) * (1 + autotune.EVENT_MARGIN), \
        (t, s1, t1, t2, s2)
    autotune.clear_memo()
