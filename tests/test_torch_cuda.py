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


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 6), (1, 1)])
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


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 3), (6, 6), (1, 1)])
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


@pytest.mark.parametrize("br,bk,bc", [(3, 3, 6), (6, 3, 6), (6, 6, 6),
                                      (1, 1, 1)])
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


def test_fused_pair_gemm_allocates_only_its_output(dev, monkeypatch):
    """The port's half of the reference's jaxpr pin against a pair-product
    intermediate: one launch on level-2-AP-sized operands (136,093 tile
    rows of 21 6x6 slots) raises the peak allocation by no more than its
    output plus 1 MiB; neither the gathered operands nor the
    ``(npairs, 6, 6)`` pair products reach device memory."""
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    g = torch.Generator(device=dev).manual_seed(170)
    f64 = dict(dtype=torch.float64, device=dev)
    rows, kmax, na, nb = 136_093, 21, 409_640, 15_884
    a = torch.randn(na, 6, 6, generator=g, **f64)
    b = torch.randn(nb, 6, 6, generator=g, **f64)
    ta = torch.randint(0, na, (rows, kmax), generator=g, device=dev,
                       dtype=torch.int32)
    tb = torch.randint(0, nb, (rows, kmax), generator=g, device=dev,
                       dtype=torch.int32)
    mask = torch.rand(rows, kmax, generator=g, device=dev) < 0.9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = _launch_once(gemm_ops, lambda: gemm_ops.fused_pair_gemm(
        a, b, ta, tb, mask))
    rise = torch.cuda.max_memory_allocated(dev) - before
    assert out.shape == (rows, 6, 6)
    assert rise <= out.nbytes + (1 << 20), rise


def _pair_operands(dev, seed, rows, kmax, shape, lhs):
    """A tile plan of ``rows`` x ``kmax`` slots over (na, br, bk) lhs and
    (nb, bk, bc) rhs blocks.  ``lhs``: "narrow" keeps each run of 40 rows
    inside a 40-block range of the lhs (staged as one range), "random"
    spreads it over all 5,000 blocks (gathered per pair), "odd" uses only
    odd lhs indices (3x3 blocks then start 8-byte aligned).  Slots are
    masked at random, rows 3..9 entirely; slot (0, 0) reads the last lhs
    and rhs block."""
    br, bk, bc = shape
    na, nb = 5000, 3000
    rng = np.random.default_rng(seed)
    if lhs == "narrow":
        base = np.minimum((np.arange(rows) // 40) * 7, na - 40)
        ta = base[:, None] + rng.integers(0, 40, (rows, kmax))
    else:
        ta = rng.integers(0, na, (rows, kmax))
        if lhs == "odd":
            ta |= 1
    tb = rng.integers(0, nb, (rows, kmax))
    mask = rng.random((rows, kmax)) < 0.7
    mask[3:10] = False
    ta[0, 0], tb[0, 0], mask[0, 0] = na - 1, nb - 1, True

    def t(x, dt):
        return torch.as_tensor(x).to(device=dev, dtype=dt)
    return (t(rng.standard_normal((na, br, bk)), torch.float64),
            t(rng.standard_normal((nb, bk, bc)), torch.float64),
            t(ta, torch.int32), t(tb, torch.int32), t(mask, torch.bool))


#: (rows, kmax, shape, lhs) on a 132-SM card at 256 threads.  Rows of up to
#: 32 slots take the direct path at 40 rows a CTA (80 for 3-row blocks;
#: 11 for 3,001 rows), longer ones the cp.async ring at 2 rows a CTA for
#: 537 rows, 11 for 3,001 and 22 for 6,000, in chunks of 10 slots a row
#: (21 for (6,3,6)).
#: Covered: tile-row counts that do not divide the rows per CTA, kmax 1,
#: the last direct and first ring width, a chunk multiple -1 / +1, the
#: level-2 R(AP) width 409, several index windows (100 slots at 22 rows a
#: CTA, 1,000 at 2), lhs ranges staged and too large to stage, odd 3x3
#: lhs indices
PAIR_RAGGED = [(11111, 6, (6, 6, 6), "narrow"), (11111, 6, (3, 3, 6), "odd"),
               (11111, 4, (3, 3, 6), "narrow"),
               (11111, 2, (6, 3, 6), "random"), (5, 1, (3, 3, 6), "odd"),
               (3001, 32, (6, 6, 6), "random"), (3001, 33, (6, 6, 6), "narrow"),
               (537, 409, (6, 6, 6), "random"), (537, 39, (6, 6, 6), "narrow"),
               (537, 41, (6, 6, 6), "random"), (537, 43, (6, 3, 6), "random"),
               (537, 41, (6, 3, 6), "narrow"), (6000, 100, (6, 6, 6), "narrow"),
               (6000, 100, (3, 3, 6), "random"),
               (600, 1000, (6, 6, 6), "narrow"),
               (600, 1000, (3, 3, 6), "random"),
               # the scalar baseline's (1, 1, 1) products
               (11111, 6, (1, 1, 1), "odd"), (3001, 32, (1, 1, 1), "narrow"),
               (3001, 33, (1, 1, 1), "random"),
               (537, 409, (1, 1, 1), "narrow"),
               (600, 1000, (1, 1, 1), "random")]


@pytest.mark.parametrize("rows,kmax,shape,lhs", PAIR_RAGGED)
def test_fused_pair_gemm_at_ragged_shapes(dev, rows, kmax, shape, lhs):
    """The staged kernel against the plain version at ragged plans, every
    ``threads`` candidate (and 1024) bitwise the 256-thread launch; rows
    with every slot masked are an exact 0.0."""
    ops = _pair_operands(dev, 180 + rows + kmax, rows, kmax, shape, lhs)
    want = _launch_once(gemm_ops, lambda: gemm_ops.fused_pair_gemm(
        *ops, threads=256))
    _close(want, fused_pair_gemm_ref(*ops))
    assert torch.equal(want[3:10], torch.zeros_like(want[3:10]))
    assert not torch.signbit(want[3:10]).any()
    for t in autotune.CANDIDATES["fused_pair_gemm"]["threads"] + (1024,):
        assert torch.equal(gemm_ops.fused_pair_gemm(*ops, threads=t),
                           want), t
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(3, 3, 6), (6, 3, 6), (6, 6, 6)])
def test_fused_pair_gemm_copies_misaligned_operands(dev, shape):
    """Operands at an 8-byte offset take the 8-byte copies and give the
    bits of the aligned launch."""
    ops = _pair_operands(dev, 190, 700, 9, shape, "narrow")
    a, b = ops[:2]
    want = gemm_ops.fused_pair_gemm(*ops)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view
    for a2, b2 in ((shifted(a), b), (a, shifted(b)),
                   (shifted(a), shifted(b))):
        assert a2.data_ptr() % 16 or b2.data_ptr() % 16
        assert torch.equal(gemm_ops.fused_pair_gemm(a2, b2, *ops[2:]), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("br,bc", [(3, 3), (3, 6), (6, 3), (6, 6)])
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
        prob = assemble_elasticity(7, path="host", device=d)
        solver = GAMGSolver(prob.A, prob.B, coarse_size=12,
                            coarsener="greedy")
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
    prob = assemble_elasticity(7, path="host", device=dev)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=12, coarsener="greedy")
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
        prob = assemble_elasticity(7, path="host", device=d)
        solver = GAMGSolver(prob.A, prob.B, coarse_size=12,
                            coarsener="greedy")
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
    prob = assemble_elasticity(4, path="host", device=dev)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=12, coarsener="greedy")
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


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("nbr", [1, 37, 131, 1001])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_pbjacobi_kernel_at_ragged_and_misaligned_tiles(dev, bs, nbr,
                                                        offset):
    """Ragged row counts, and dinv / r / x starting 8 bytes off 16 (a view
    one double into its buffer): every ``threads`` candidate, with omega
    by value and as a device tensor, is bitwise the 256-thread launch on
    aligned copies, which is within 1e-12 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(90 + bs + nbr)
    f64 = dict(dtype=torch.float64, device=dev)
    n = nbr * bs
    dbuf = torch.randn(offset + n * bs, generator=g, **f64)
    rbuf, xbuf = (torch.randn(offset + n, generator=g, **f64)
                  for _ in range(2))
    dinv = dbuf[offset:].view(nbr, bs, bs)
    r, x = (b[offset:].view(nbr, bs) for b in (rbuf, xbuf))
    assert (dinv.data_ptr() % 16 == 8) == bool(offset)
    want = pbj_ops.pbjacobi_update(dinv.clone(), r.clone(), x.clone(), 0.7,
                                   threads=256)
    _close(want, pbjacobi_update_ref(dinv, r, x, 0.7))
    w = torch.tensor([0.7], **f64)
    for t in autotune.CANDIDATES["pbjacobi"]["threads"]:
        for omega in (0.7, w):
            got = _launch_once(pbj_ops, lambda: pbj_ops.pbjacobi_update(
                dinv, r, x, omega, threads=t))
            assert torch.equal(got, want), (t, type(omega))


def test_pbjacobi_number_omega_is_one_launch(dev):
    """A number omega travels by value: the call launches the kernel and
    nothing else (no device write of omega first)."""
    from torch.profiler import ProfilerActivity, profile
    f64 = dict(dtype=torch.float64, device=dev)
    dinv = torch.eye(6, **f64).expand(50, 6, 6).contiguous()
    r, x = torch.ones(50, 6, **f64), torch.zeros(50, 6, **f64)
    pbj_ops.pbjacobi_update(dinv, r, x, 0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = pbj_ops.pbjacobi_update(dinv, r, x, 0.5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.equal(out, torch.full_like(x, 0.5))
    assert len(names) == 1 and "pbjacobi" in names[0], names


@pytest.mark.parametrize("nbr,threads", [(1000, 128), (7, 32), (50, 1024)])
def test_launch_record_notes_each_launch_and_its_grid(dev, nbr, threads):
    """``autotune.launch_record`` counts one launch a wrapper call and
    gives its grid (3 nbr outputs over ``threads``); the empty kernel that
    times the floor is not noted."""
    f64 = dict(dtype=torch.float64, device=dev)
    dinv = torch.eye(3, **f64).expand(nbr, 3, 3).contiguous()
    r, x = torch.ones(nbr, 3, **f64), torch.zeros(nbr, 3, **f64)
    before = autotune.launch_record()[0]
    pbj_ops.pbjacobi_update(dinv, r, x, 0.5, threads=threads)
    torch.cuda.synchronize()
    assert autotune.launch_record() == (
        before + 1, -(-3 * nbr // threads), threads)
    autotune.launch_floor_ms(5, 64)
    assert autotune.launch_record() == (
        before + 1, -(-3 * nbr // threads), threads)


def test_mis_aggregates_on_card_match_cpu(dev):
    """The device Luby-MIS coarsener on the card, at m=7 (device
    assembly, coarse_size 12): levels, rounds and aggregates equal the
    port's on the CPU."""
    from repro_torch.core import gamg
    out = {}
    for d in ("cpu", dev):
        prob = assemble_elasticity(7, device=d)
        out[str(d)] = gamg.setup(prob.A, prob.B, coarse_size=12,
                                 coarsener="mis")
    cpu, card = out.values()
    assert card.stats["level_rows"] == cpu.stats["level_rows"] == \
        [882, 204, 114, 18]
    assert card.stats["mis_rounds"] == cpu.stats["mis_rounds"]
    for a, b in zip(cpu.levels, card.levels):
        np.testing.assert_array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg)


def test_coefficient_update_moves_only_the_fields(dev):
    """One coefficient update on the card copies at most the two
    per-element fields (and 4 KB) host to device: every aten copy from a
    CPU tensor to the card (``obs.transfer.count_h2d``; the kernel
    library copies nothing itself), checked against a known copy first."""
    from repro_torch.fem.assemble import inclusion_fields
    from repro_torch.obs.transfer import count_h2d

    def h2d(fn):
        return count_h2d(fn)[1]

    probe = torch.ones(1 << 16, dtype=torch.float64)
    assert h2d(lambda: probe.to(dev)) == probe.numel() * 8
    prob = assemble_elasticity(6, device=dev)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=12)
    solver.bind_assembler(prob.assembler)
    E, nu = inclusion_fields(prob.mesh, E_inclusion=100.0)
    solver.update_coefficients(E, nu)
    ne = prob.mesh.n_elements
    assert 2 * ne * 8 <= h2d(lambda: solver.update_coefficients(E, nu)) \
        <= 2 * ne * 8 + 4096


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
                       p(r), p(w), 0.0, p(torch.empty_like(r)), 4, 3,
                       threads)


#: ragged (nbr, kmax, br, bc): kmax not a multiple of the lanes, kmax
#: below them, kmax 1 and 490 (A2's width), nbr not a multiple of the
#: rows per block, nbr 1
RAGGED = [(37, 7, 3, 3), (5, 3, 6, 6), (70, 27, 3, 3), (1, 1, 3, 6),
          (9, 490, 6, 6), (1, 490, 6, 6), (33, 19, 6, 6), (1, 5, 3, 3),
          (41, 125, 6, 3), (3, 9, 6, 3)]
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


def _smoother_operands(dev, seed, nbr, kmax, bs, ks=(), nbc=None):
    """A square smoother operator and its vectors: ``(indices, data, dinv,
    coef)`` and ``(b, x, d)`` triples for the vector and each panel width
    in ``ks``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    nbc = nbr if nbc is None else nbc
    idx = torch.randint(0, nbc, (nbr, kmax), generator=g, device=dev,
                        dtype=torch.int32)
    op = (idx, torch.randn(nbr, kmax, bs, bs, generator=g, **f64),
          torch.randn(nbr, bs, bs, generator=g, **f64),
          torch.tensor([0.25, 0.8], **f64))
    vecs = {k: tuple(torch.randn((nbr, bs) + ((k,) if k else ()),
                                 generator=g, **f64) for _ in range(3))
            for k in (None,) + tuple(ks)}
    return op, vecs


def _step(op, v, lanes=None, threads=256):
    idx, data, dinv, coef = op
    if lanes is None:
        return smooth_ops.smoother_step_ell(idx, data, dinv, *v, coef,
                                            threads=threads)
    return smooth_ops.launch_lanes(idx, data, dinv, *v, coef, lanes,
                                   threads)


@pytest.mark.parametrize("nbr,kmax,br,bc",
                         [s for s in RAGGED if s[2] == s[3]])
def test_smoother_lanes_at_ragged_shapes(dev, nbr, kmax, br, bc):
    """The smoother at every lanes value at ragged shapes (kmax not a
    multiple of the lanes, kmax below them, nbr not a multiple of the rows
    per block): vector and panels (k 1, 3, 16, 17) against the plain
    version, each panel column bitwise the vector launch with the same
    lanes, every ``threads`` candidate bitwise the 256-thread launch."""
    op, vecs = _smoother_operands(dev, 100 + nbr + kmax + br, nbr, kmax, br,
                                  ks=(1, 3, 16, 17))
    idx, data, dinv, coef = op
    threads = autotune.CANDIDATES["fused_smoother"]["threads"] + (1024,)
    for lanes in LANES:
        for k, v in vecs.items():
            got = _step(op, v, lanes)
            _close(got, smoother_step_ref(idx, data, dinv, *v, coef))
            for t in threads:
                for a, b in zip(_step(op, v, lanes, t), got):
                    assert torch.equal(a, b), (lanes, k, t)
            for j in range(k or 0):
                col = _step(op, tuple(w[:, :, j].contiguous() for w in v),
                            lanes)
                for a, b in zip(got, col):
                    assert torch.equal(a[:, :, j], b), (lanes, k, j)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bs,kmax", [(3, 7), (3, 27), (6, 45), (6, 490)])
def test_smoother_identity_step_is_the_spmv_residual(dev, bs, kmax):
    """With ``dinv = I`` and ``coef = [0, 1]`` the step's ``d'`` is bitwise
    ``b - block_spmv_ell(A, x)``, for the vector and each panel column:
    the smoother's ``A x`` is ``block_spmv``'s at the same lanes."""
    op, vecs = _smoother_operands(dev, 110 + bs + kmax, 61, kmax, bs,
                                  ks=(5,))
    idx, data, _, _ = op
    f64 = dict(dtype=torch.float64, device=dev)
    eye = torch.eye(bs, **f64).expand(61, bs, bs).contiguous()
    ident = (idx, data, eye, torch.tensor([0.0, 1.0], **f64))
    b, x, d = vecs[None]
    _, dn = _launch_once(smooth_ops, lambda: _step(ident, (b, x, d)))
    assert torch.equal(dn, b - spmv_ops.block_spmv_ell(idx, data, x))
    b, x, d = vecs[5]
    _, dn = _step(ident, (b, x, d))
    for j in range(5):
        assert torch.equal(dn[:, :, j], b[:, :, j] - spmv_ops.block_spmv_ell(
            idx, data, x[:, :, j].contiguous())), j


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("k", [1, 3, 16, 17])
def test_smoother_panel_columns_are_the_vector_step(dev, bs, k):
    """Each column of a width-k panel step is bitwise the vector step (the
    panel takes chunks of 1, 2, 4 or 8 columns by k and bs)."""
    op, vecs = _smoother_operands(dev, 120 + bs + k, 300, 45, bs, ks=(k,))
    v = vecs[k]
    got = _launch_once(smooth_ops, lambda: _step(op, v))
    _close(got, smoother_step_ref(*op[:3], *v, op[3]))
    for j in range(k):
        xj, dj = _step(op, tuple(w[:, :, j].contiguous() for w in v))
        assert torch.equal(got[0][:, :, j], xj)
        assert torch.equal(got[1][:, :, j], dj)


def test_smoother_wrapper_launches_the_lanes_map(dev):
    from repro_torch.kernels import ell_rows
    for seed, (kmax, bs) in enumerate(((27, 3), (45, 6), (490, 6))):
        op, vecs = _smoother_operands(dev, 130 + seed, 60, kmax, bs, ks=(4,))
        lanes = ell_rows.lanes(bs, bs, kmax)
        for v in vecs.values():
            for a, b in zip(_step(op, v), _step(op, v, lanes)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("k", [None, 16])
def test_smoother_step_allocates_only_its_outputs(dev, monkeypatch, k):
    """The port's half of the reference's jaxpr pin against full-length
    intermediates: one step on A2-sized operands (836 rows of 490 6x6
    slots) raises the peak allocation by no more than ``x'`` and ``d'``
    plus 1 MiB; ``r`` and ``z`` never reach device memory."""
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    op, vecs = _smoother_operands(dev, 140, 836, 490, 6, ks=(16,))
    v = vecs[k]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    x_new, d_new = _launch_once(smooth_ops, lambda: _step(op, v, threads=None))
    rise = torch.cuda.max_memory_allocated(dev) - before
    assert rise <= x_new.nbytes + d_new.nbytes + (1 << 20), rise


@pytest.mark.parametrize("lanes", [0, 3, 12, 64, -4])
def test_smoother_c_entries_refuse_bad_lanes(dev, lanes):
    op, vecs = _smoother_operands(dev, 150, 4, 2, 3, ks=(2,))
    for v in vecs.values():
        with pytest.raises(RuntimeError, match="CUDA error"):
            _step(op, v, lanes)


def test_smoother_c_entries_refuse_misaligned_payloads(dev):
    """6x6 blocks are read in 16-byte pairs."""
    op, vecs = _smoother_operands(dev, 160, 4, 2, 6, ks=(2,))
    idx, data, dinv, coef = op
    flat = torch.zeros(1 + data.numel(), dtype=torch.float64, device=dev)
    off = flat[1:].view(data.shape)
    for v in vecs.values():
        with pytest.raises(RuntimeError, match="CUDA error"):
            _step((idx, off, dinv, coef), v, 4)
        with pytest.raises(ValueError, match="16-byte aligned"):
            _step((idx, off, dinv, coef), v)


# ---------------------------------------------------------------------------
# The f32 and bf16 instantiations (the reduced-precision policies)
# ---------------------------------------------------------------------------

#: payload dtype -> tolerance of the largest term (the reference's own,
#: tests/test_kernels.py:41-48) and the accumulator of its Galerkin
#: products (the policy's kernel_accum_dtype)
LOW = {torch.float32: (2e-5, None), torch.bfloat16: (5e-2, torch.float32)}
LOW_IDS = ["f32", "bf16"]


def _low(dev, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device=dev).to(dt)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    return randn, randint


def _near(got, want, tol):
    got = torch.cat([t.reshape(-1) for t in got]) if isinstance(
        got, tuple) else got
    want = torch.cat([t.reshape(-1) for t in want]) if isinstance(
        want, tuple) else want
    assert got.dtype == want.dtype
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * float(want.double().abs().max()), err


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
@pytest.mark.parametrize("br,bc,kmax", [(3, 3, 27), (3, 6, 8), (6, 6, 45),
                                        (6, 6, 490), (6, 3, 125)])
def test_low_precision_ell_kernels_match_plain(dev, dt, br, bc, kmax):
    """block_spmv, block_spmm, the vector and panel smoother and pbjacobi
    at f32 and bf16 (acc = the payload; bf16 also at an f32 accumulator)
    against their plain versions on the same card tensors."""
    tol, _ = LOW[dt]
    randn, randint = _low(dev, dt, 7 * kmax + br)
    nbr = 300 if kmax > 100 else 2000
    idx, data = randint(nbr, nbr, kmax), randn(nbr, kmax, br, bc)
    accs = (None, torch.float32) if dt == torch.bfloat16 else (None,)
    for acc in accs:
        x, X = randn(nbr, bc), randn(nbr, bc, 5)
        _near(_launch_once(spmv_ops, lambda: spmv_ops.block_spmv_ell(
            idx, data, x, accum_dtype=acc)),
            block_spmv_ell_ref(idx, data, x, accum_dtype=acc), tol)
        _near(_launch_once(spmm_ops, lambda: spmm_ops.block_spmm_ell(
            idx, data, X, accum_dtype=acc)),
            block_spmm_ell_ref(idx, data, X, accum_dtype=acc), tol)
        if br != bc:
            continue
        dinv = randn(nbr, br, br)
        coef = torch.tensor([0.25, 0.8], device=dev, dtype=dt)
        for cols in ((), (16,)):
            v = tuple(randn(nbr, br, *cols) for _ in range(3))
            _near(_launch_once(smooth_ops, lambda: smooth_ops
                               .smoother_step_ell(idx, data, dinv, *v, coef,
                                                  accum_dtype=acc)),
                  smoother_step_ref(idx, data, dinv, *v, coef,
                                    accum_dtype=acc), tol)
        r, x = randn(nbr, br), randn(nbr, br)
        _near(_launch_once(pbj_ops, lambda: pbj_ops.pbjacobi_update(
            dinv, r, x, 0.6, accum_dtype=acc)),
            pbjacobi_update_ref(dinv, r, x, 0.6, accum_dtype=acc), tol)


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
@pytest.mark.parametrize("br,bk,bc", [(3, 3, 6), (6, 3, 6), (6, 6, 6)])
def test_low_precision_galerkin_kernels_match_plain(dev, dt, br, bk, bc):
    """fused_pair_gemm (direct and ring widths, an odd-offset lhs),
    block_pair_gemm (bf16 also with its products kept at f32) and the
    block_seg_sum combine at the policy's accumulator."""
    tol, acc = LOW[dt]
    randn, randint = _low(dev, dt, 100 * br + 10 * bk + bc)
    na, nb = 5000, 3000
    a, b = randn(na + 1, br, bk)[1:], randn(nb, bk, bc)
    for rows, kmax in ((4000, 6), (2000, 21), (300, 409)):
        ta, tb = randint(na, rows, kmax), randint(nb, rows, kmax)
        mask = torch.rand(rows, kmax, device=dev) < 0.8
        out = _launch_once(gemm_ops, lambda: gemm_ops.fused_pair_gemm(
            a, b, ta, tb, mask, accum_dtype=acc))
        _near(out, fused_pair_gemm_ref(a, b, ta, tb, mask, accum_dtype=acc),
              tol)
        cuts = torch.randint(0, rows + 1, (rows // 3,), device=dev).sort()[0]
        ends = torch.tensor([0, rows], device=dev)
        offs = torch.cat([ends[:1], cuts, ends[1:]]).to(torch.int32)
        _near(_launch_once(seg_ops, lambda: seg_ops.block_seg_sum(
            out, offs, accum_dtype=acc)),
            block_seg_sum_ref(out, offs, accum_dtype=acc), tol)
    lhs, rhs = randn(20000, br, bk), randn(20000, bk, bc)
    kws = [dict(accum_dtype=acc)]
    if dt == torch.bfloat16:
        kws.append(dict(accum_dtype=acc, out_dtype=torch.float32))
    for kw in kws:
        _near(_launch_once(pair_ops, lambda: pair_ops.block_pair_gemm(
            lhs, rhs, **kw)), block_pair_gemm_ref(lhs, rhs, **kw), tol)


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
@pytest.mark.parametrize("bs,kmax", [(3, 27), (6, 45), (6, 490)])
def test_low_precision_bitwise_contracts(dev, dt, bs, kmax):
    """At f32 and bf16 (acc = the payload): each block_spmm column is
    bitwise block_spmv, each panel smoother column bitwise the vector step,
    the identity smoother's d' bitwise b - block_spmv(x), and every threads
    candidate bitwise the 256-thread launch."""
    randn, randint = _low(dev, dt, 11 * kmax + bs)
    nbr, k = 300, 16
    idx, data, dinv = randint(nbr, nbr, kmax), randn(nbr, kmax, bs, bs), \
        randn(nbr, bs, bs)
    coef = torch.tensor([0.25, 0.8], device=dev, dtype=dt)
    X = randn(nbr, bs, k)
    Y = spmm_ops.block_spmm_ell(idx, data, X)
    b, x, d = (randn(nbr, bs, k) for _ in range(3))
    xp, dp = smooth_ops.smoother_step_ell(idx, data, dinv, b, x, d, coef)
    eye = torch.eye(bs, device=dev, dtype=dt).expand(nbr, bs, bs)
    step = torch.tensor([0.0, 1.0], device=dev, dtype=dt)
    _, di = smooth_ops.smoother_step_ell(idx, data, eye.contiguous(), b, x,
                                         d, step)
    for j in range(k):
        col = [v[:, :, j].contiguous() for v in (X, b, x, d)]
        assert torch.equal(Y[:, :, j], spmv_ops.block_spmv_ell(idx, data,
                                                               col[0]))
        xv, dv = smooth_ops.smoother_step_ell(idx, data, dinv, *col[1:],
                                              coef)
        assert torch.equal(xp[:, :, j], xv) and torch.equal(dp[:, :, j], dv)
        assert torch.equal(di[:, :, j], col[1] - spmv_ops.block_spmv_ell(
            idx, data, col[2]))
    runs = {"block_spmv": lambda t: spmv_ops.block_spmv_ell(
                idx, data, X[:, :, 0].contiguous(), threads=t),
            "block_spmm": lambda t: spmm_ops.block_spmm_ell(
                idx, data, X, threads=t),
            "fused_smoother": lambda t: smooth_ops.smoother_step_ell(
                idx, data, dinv, b, x, d, coef, threads=t)[0],
            "pbjacobi": lambda t: pbj_ops.pbjacobi_update(
                dinv, b[:, :, 0].contiguous(), x[:, :, 0].contiguous(), 0.6,
                threads=t)}
    for family, run in runs.items():
        want = run(autotune.DEFAULT_THREADS)
        for t in autotune.CANDIDATES[family]["threads"]:
            assert torch.equal(run(t), want), (family, t)


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
def test_low_precision_steps_allocate_only_their_outputs(dev, dt,
                                                         monkeypatch):
    """The two allocation pins at f32 and bf16: a smoother step on
    A2-sized operands (vector and k=16 panel) and a fused_pair_gemm launch
    on level-2-AP-sized operands raise the peak allocation by no more than
    their outputs plus 1 MiB."""
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    randn, randint = _low(dev, dt, 180)
    idx, data, dinv = randint(836, 836, 490), randn(836, 490, 6, 6), \
        randn(836, 6, 6)
    coef = torch.tensor([0.25, 0.8], device=dev, dtype=dt)
    for cols in ((), (16,)):
        v = tuple(randn(836, 6, *cols) for _ in range(3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        xn, dn = smooth_ops.smoother_step_ell(idx, data, dinv, *v, coef)
        rise = torch.cuda.max_memory_allocated(dev) - before
        assert rise <= xn.nbytes + dn.nbytes + (1 << 20), rise
    rows, kmax, na, nb = 136_093, 21, 409_640, 15_884
    a, b = randn(na, 6, 6), randn(nb, 6, 6)
    ta, tb = randint(na, rows, kmax), randint(nb, rows, kmax)
    mask = torch.rand(rows, kmax, device=dev) < 0.9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = gemm_ops.fused_pair_gemm(a, b, ta, tb, mask,
                                   accum_dtype=LOW[dt][1])
    rise = torch.cuda.max_memory_allocated(dev) - before
    assert rise <= out.nbytes + (1 << 20), rise


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
def test_low_precision_refuses_misaligned_payloads(dev, dt):
    """Even-width blocks are read in pairs (8 bytes at f32, 4 at bf16): a
    payload one element off is refused by the wrappers and the C entries;
    a reduced payload beside an f64 vector, or without its instantiation
    (f64 accumulator), raises before any launch."""
    randn, randint = _low(dev, dt, 190)
    nbr, kmax = 40, 4
    idx = randint(nbr, nbr, kmax)
    data = randn(1 + nbr * kmax * 36)[1:].view(nbr, kmax, 6, 6)
    x = randn(nbr, 6)
    pair = 2 * data.element_size()
    with pytest.raises(ValueError, match=f"{pair}-byte aligned"):
        spmv_ops.block_spmv_ell(idx, data, x)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmv_ops.launch_lanes(idx, data, x, 4, 256)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmm_ops.launch_lanes(idx, data, randn(nbr, 6, 3), 4, 256)
    good = data.clone()
    with pytest.raises(ValueError, match="one payload dtype"):
        spmv_ops.block_spmv_ell(idx, good, x.double())
    with pytest.raises(ValueError, match="instantiation"):
        spmv_ops.block_spmv_ell(idx, good, x, accum_dtype=torch.float64)


# ---------------------------------------------------------------------------
# The stored restriction (6x3 kernels) and the recovery ladder on the card
# ---------------------------------------------------------------------------

def test_stored_restriction_on_card_matches_transpose_free(dev):
    """``restriction="stored"`` at m=7: ``R0`` applied by the 6x3
    ``block_spmv`` / ``block_spmm``; iterations equal to the
    transpose-free solve, solutions within 1e-12, vector and k=4 panel."""
    prob = assemble_elasticity(7, path="host", device=dev)
    opts = dict(coarse_size=12, coarsener="greedy")
    tf = GAMGSolver(prob.A, prob.B, **opts)
    st = GAMGSolver(prob.A, prob.B, restriction="stored", **opts)
    assert st.setup_data.levels[0].r_ell.data.shape[2:] == (6, 3)
    before = (spmv_ops.launches_by_shape[(6, 3)],
              spmm_ops.launches_by_shape[(6, 3)])
    a, b = tf.solve(prob.b), st.solve(prob.b)
    assert a.iters == b.iters and int(b.health.status) == 0
    _close(b.x, a.x)
    B = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (prob.n, 4)), device=dev)
    pa, pb = tf.solve_many(B), st.solve_many(B)
    assert torch.equal(pa.iters, pb.iters)
    _close(pb.x, pa.x)
    torch.cuda.synchronize()
    assert spmv_ops.launches_by_shape[(6, 3)] > before[0]
    assert spmm_ops.launches_by_shape[(6, 3)] > before[1]


def test_recovery_ladder_on_card(dev):
    """m=6 on the card: a transient ``precond`` fault is recovered by the
    recompute rung with the healthy solution's bits, and a second solve
    under the schedule is ``ok`` on the rung's closures; a persistent one
    climbs every rung, the last on the ``pairs`` kernels, and degrades,
    as the reference does on the CPU, and a later ``update_operator``
    stays on the ``pairs`` kernels.  Each faulted solver is built under
    its schedule, as the reference's schedules bind at trace time."""
    from repro_torch.robust import inject
    from repro_torch.robust.recover import RobustSolver
    prob = assemble_elasticity(6, path="host", device=dev)
    opts = dict(coarse_size=100, coarsener="greedy")
    ok = RobustSolver(prob.A, prob.B, **opts).solve(prob.b)
    assert ok.status == "ok"
    with inject.active(inject.parse_schedule("precond:nan@3")):
        rs = RobustSolver(prob.A, prob.B, **opts)
        rec = rs.solve(prob.b)
        again = rs.solve(prob.b)
    assert (rec.status, rec.attempts) == ("recovered", ("recompute",))
    assert torch.equal(rec.x, ok.x)
    assert again.status == "ok" and torch.equal(again.x, ok.x)
    before = pair_ops.launches
    with inject.active(inject.parse_schedule("precond:nan@3:persistent")):
        rs = RobustSolver(prob.A, prob.B, **opts)
        bad = rs.solve(prob.b)
    assert (bad.status, bad.attempts) == (
        "degraded", ("recompute", "re-setup", "reference-path"))
    assert pair_ops.launches > before
    assert bool(torch.isfinite(bad.x).all())
    before = pair_ops.launches
    rs.update_operator(prob.A.data)
    torch.cuda.synchronize()
    assert pair_ops.launches > before


# ---------------------------------------------------------------------------
# Observability and the time march on the card
# ---------------------------------------------------------------------------

def test_spans_and_counters_bitwise_off_on_card(dev):
    """m=7 on the card: the spans and counters solves, vector and k=4
    panel, are bitwise the off solve (a range adds no launch, a tally
    only adds its own), and the vector tally takes ``iters + 1``
    cycles."""
    from repro_torch.core import gamg
    from repro_torch.multirhs.block_krylov import make_block_solve
    prob = assemble_elasticity(7, path="host", device=dev)
    sd = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy")
    hier = gamg.make_recompute(sd)(prob.A.data)
    B = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (prob.n, 4)), device=dev)
    out = {mode: (gamg.make_solve(sd, obs=mode)(hier, prob.b),
                  make_block_solve(sd, obs=mode)(hier, B))
           for mode in ("off", "spans", "counters")}
    off, poff = out["off"]
    for mode in ("spans", "counters"):
        res, pres = out[mode]
        assert res.iters == off.iters and torch.equal(res.x, off.x)
        assert torch.equal(pres.iters, poff.iters)
        assert torch.equal(pres.x, poff.x)
    tally = out["counters"][0].counters
    assert tally.precond_applies.is_cuda
    assert int(tally.precond_applies) == off.iters + 1
    assert tally.smoother_applies.tolist() == [2 * (off.iters + 1)] * 2


def test_frozen_segment_copies_nothing_host_to_device(dev):
    """A frozen march segment at m=5 on the card: after its first step
    (which puts the setup's index arrays on the device), the next steps
    copy no byte from the host (``obs.transfer.count_h2d``)."""
    from repro_torch import sim
    from repro_torch.obs.transfer import count_h2d
    from repro_torch.sim.driver import _setup_from_fields
    prob = assemble_elasticity(5, device=dev)
    scen = sim.SofteningScenario.build(prob, rate=0.25)
    cfg = sim.MarchConfig(n_steps=4, seg_len=8, staleness=sim.StalenessConfig(
        iter_drift=10**6, ref_window=1, coeff_rtol=10**6))
    carry = sim.init_carry(scen, prob.b)
    E, nu, _ = scen.step_fields(carry.scen, carry.x, carry.step)
    sd = _setup_from_fields(prob, E, nu, {"coarse_size": 8})
    seg = sim.make_segment(sd, prob.assembler, scen, cfg)
    k, carry, _, _ = seg(prob.b, carry, 1)
    assert k == 1
    (k, carry, recs, blocked), nbytes, count = count_h2d(
        lambda: seg(prob.b, carry, cfg.n_steps))
    torch.cuda.synchronize()
    assert k == 3 and not bool(blocked) and int(carry.step) == 4
    assert (nbytes, count) == (0, 0)
    assert recs.status[:3].tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# The scalar (AIJ) baseline's entries: block_spmv, fused_pair_gemm and
# block_seg_sum at 1x1, and the scalar-row fused_smoother
# ---------------------------------------------------------------------------

#: (nbr, kmax) of 1x1 ELL operators: kmax 1, 31 and 33 (around a warp of
#: lanes), 81 (A0s) and 2,940 (A2s); nbr not a multiple of any CTA's rows
SCALAR_RAGGED = [(37, 1), (1001, 31), (259, 33), (131, 81), (9, 2940)]


def _scalar_operands(dev, seed, nodes, bs, kmax, dt=torch.float64):
    """A square 1x1 ELL operator of ``nodes * bs`` rows, node blocks
    ``dinv (nodes, bs, bs)`` and ``(nodes, bs)`` vectors."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device=dev).to(dt)
    n = nodes * bs
    idx = torch.randint(0, n, (n, kmax), generator=g, device=dev,
                        dtype=torch.int32)
    return (idx, randn(n, kmax, 1, 1), randn(nodes, bs, bs),
            randn(nodes, bs), randn(nodes, bs), randn(nodes, bs),
            torch.tensor([0.25, 0.8], dtype=torch.float64,
                         device=dev).to(dt))


@pytest.mark.parametrize("nbr,kmax", SCALAR_RAGGED)
def test_scalar_spmv_at_ragged_shapes(dev, nbr, kmax):
    """``block_spmv`` at 1x1: every lanes value against the plain version,
    every ``threads`` candidate bitwise the 256-thread launch, and the
    wrapper's launch the map's."""
    from repro_torch.kernels import ell_rows
    g = torch.Generator(device=dev).manual_seed(200 + nbr + kmax)
    f64 = dict(dtype=torch.float64, device=dev)
    idx = torch.randint(0, 97, (nbr, kmax), generator=g, device=dev,
                        dtype=torch.int32)
    data = torch.randn(nbr, kmax, 1, 1, generator=g, **f64)
    x = torch.randn(97, 1, generator=g, **f64)
    want = block_spmv_ell_ref(idx, data, x)
    threads = autotune.CANDIDATES["block_spmv"]["threads"] + (1024,)
    for lanes in LANES:
        y = spmv_ops.launch_lanes(idx, data, x, lanes, 256)
        _close(y, want)
        for t in threads:
            assert torch.equal(spmv_ops.launch_lanes(idx, data, x, lanes, t),
                               y), (lanes, t)
    before = spmv_ops.launches_by_shape[(1, 1)]
    got = _launch_once(spmv_ops, lambda: spmv_ops.block_spmv_ell(idx, data,
                                                                 x))
    assert spmv_ops.launches_by_shape[(1, 1)] == before + 1
    assert torch.equal(got, spmv_ops.launch_lanes(
        idx, data, x, ell_rows.lanes(1, 1, kmax), 256))


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("nodes,kmax", [(13, 1), (337, 31), (87, 33),
                                        (41, 81), (3, 2940)])
def test_scalar_smoother_at_ragged_shapes(dev, bs, nodes, kmax):
    """The scalar-row step: every lanes value against the plain version,
    every ``threads`` candidate bitwise the 256-thread launch; one counted
    launch through the wrapper at the map's lanes."""
    from repro_torch.kernels import ell_rows
    from repro_torch.kernels.fused_smoother.ref import \
        smoother_step_scalar_ref
    op = _scalar_operands(dev, 210 + bs + nodes + kmax, nodes, bs, kmax)
    want = smoother_step_scalar_ref(*op)
    threads = autotune.CANDIDATES["fused_smoother"]["threads"] + (1024,)
    for lanes in LANES:
        got = smooth_ops.launch_scalar_lanes(*op, lanes, 256)
        _close(got, want)
        for t in threads:
            again = smooth_ops.launch_scalar_lanes(*op, lanes, t)
            assert all(torch.equal(a, b) for a, b in zip(again, got)), \
                (lanes, t)
    before = smooth_ops.launches_by_shape[(1, bs)]
    got = _launch_once(smooth_ops,
                       lambda: smooth_ops.smoother_step_scalar_ell(*op))
    assert smooth_ops.launches_by_shape[(1, bs)] == before + 1
    at_map = smooth_ops.launch_scalar_lanes(*op, ell_rows.lanes(1, 1, kmax),
                                            256)
    assert all(torch.equal(a, b) for a, b in zip(got, at_map))


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("kmax", [1, 31, 33, 2940])
def test_scalar_smoother_identity_step_is_the_spmv_residual(dev, bs, kmax):
    """With ``dinv = I`` and ``coef = [0, 1]`` the scalar-row step's
    ``d'`` is bitwise ``b - block_spmv(x)`` at 1x1."""
    idx, data, _, b, x, d, _ = _scalar_operands(dev, 230 + bs + kmax, 29,
                                                bs, kmax)
    f64 = dict(dtype=torch.float64, device=dev)
    eye = torch.eye(bs, **f64).expand(29, bs, bs).contiguous()
    _, dn = _launch_once(smooth_ops, lambda: smooth_ops.
                         smoother_step_scalar_ell(
                             idx, data, eye, b, x, d,
                             torch.tensor([0.0, 1.0], **f64)))
    ax = spmv_ops.block_spmv_ell(idx, data, x.reshape(-1, 1))
    assert torch.equal(dn.reshape(-1), b.reshape(-1) - ax.reshape(-1))


@pytest.mark.parametrize("lanes", [0, 3, 12, 64, -4])
def test_scalar_smoother_c_entry_refuses_bad_lanes(dev, lanes):
    op = _scalar_operands(dev, 240, 4, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        smooth_ops.launch_scalar_lanes(*op, lanes, 256)


def test_scalar_smoother_refuses_panels_and_other_nodes(dev):
    """The card's scalar-row entry takes vectors and node blocks of 3 or
    6; the C entry refuses other node sizes."""
    idx, data, dinv, b, x, d, coef = _scalar_operands(dev, 250, 5, 3, 4)
    B = torch.stack([b, b], dim=2)
    with pytest.raises(ValueError, match="vectors only"):
        smooth_ops.smoother_step_scalar_ell(idx, data, dinv, B, B, B, coef)
    op4 = _scalar_operands(dev, 251, 5, 4, 4)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        smooth_ops.smoother_step_scalar_ell(*op4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        smooth_ops.launch_scalar_lanes(*op4, 1, 256)


@pytest.mark.parametrize("dt", list(LOW), ids=LOW_IDS)
def test_low_precision_scalar_entries_match_plain(dev, dt):
    """The four scalar-baseline entries at f32 and bf16 against their plain
    versions at the reference's tolerances (bf16 products and sums at the
    f32 accumulator, as the bf16 policy runs them)."""
    from repro_torch.kernels.fused_smoother.ref import \
        smoother_step_scalar_ref
    tol, acc = LOW[dt]
    randn, randint = _low(dev, dt, 260)
    idx, data, x = randint(97, 301, 33), randn(301, 33, 1, 1), randn(97, 1)
    _near(spmv_ops.block_spmv_ell(idx, data, x),
          block_spmv_ell_ref(idx, data, x), tol)
    for bs in (3, 6):
        op = _scalar_operands(dev, 261 + bs, 50, bs, 81, dt)
        for accum in (None, acc):
            _near(smooth_ops.smoother_step_scalar_ell(*op, accum_dtype=accum),
                  smoother_step_scalar_ref(*op, accum_dtype=accum), tol)
    a, b = randn(400, 1, 1), randn(300, 1, 1)
    ta, tb = randint(400, 200, 9), randint(300, 200, 9)
    mask = torch.ones((200, 9), dtype=torch.bool, device=dev)
    _near(gemm_ops.fused_pair_gemm(a, b, ta, tb, mask, accum_dtype=acc),
          fused_pair_gemm_ref(a, b, ta, tb, mask, accum_dtype=acc), tol)
    vals = randn(500, 1, 1)
    offs = torch.tensor([0, 7, 7, 300, 500], dtype=torch.int32, device=dev)
    seg_acc = torch.float32 if dt == torch.bfloat16 else None
    _near(seg_ops.block_seg_sum(vals, offs, accum_dtype=seg_acc),
          block_seg_sum_ref(vals, offs, accum_dtype=seg_acc), tol)


def test_scalar_solve_on_card_matches_cpu(dev):
    """The scalar baseline at m=5 (greedy, host assembly, coarse_size 30):
    ``recompute_scalar`` and the scalar solve on the card against the
    port on the CPU (equal iterations, the blocked solve's too; solutions
    within 1e-12), launching ``block_spmv`` at 1x1 and the scalar-row
    smoother; the scalar PtAP chain within 1e-11, launching
    ``fused_pair_gemm`` at (1,1,1) and ``block_seg_sum`` at 1x1; a second
    ``recompute_scalar`` copies nothing from the host."""
    from repro_torch.core import gamg
    from repro_torch.core.scalar_path import build_scalar_ptap_chain, \
        recompute_scalar
    from repro_torch.obs.transfer import count_h2d
    out = {}
    for where in ("cpu", dev):
        prob = assemble_elasticity(5, path="host", device=where)
        sd = gamg.setup(prob.A, prob.B, coarse_size=30, coarsener="greedy")
        hier = recompute_scalar(sd, prob.A.data)
        res = gamg.hier_solve(sd, hier, prob.b)
        blocked = gamg.hier_solve(sd, gamg.recompute(sd, prob.A.data),
                                  prob.b)
        assert int(res.iters) == int(blocked.iters)
        out[str(where)] = (res, build_scalar_ptap_chain(sd)(prob.A.data),
                           sd, prob)
    (rc, chain_c, _, _), (rg, chain_g, sd, prob) = out["cpu"], \
        out[str(dev)]
    assert int(rc.iters) == int(rg.iters)
    err = float((rg.x.cpu() - rc.x).abs().max() / rc.x.abs().max())
    assert err <= 1e-12, err
    for g, c in zip(chain_g, chain_c):
        err = float((g.cpu() - c).abs().max() / c.abs().max())
        assert err <= 1e-11, err
    before = (spmv_ops.launches_by_shape[(1, 1)],
              smooth_ops.launches_by_shape[(1, 3)],
              gemm_ops.launches_by_shape[(1, 1, 1)],
              seg_ops.launches_by_shape[(1, 1)])
    hier = recompute_scalar(sd, prob.A.data * 1.1)
    gamg.hier_solve(sd, hier, prob.b)
    build_scalar_ptap_chain(sd)(prob.A.data)
    torch.cuda.synchronize()
    after = (spmv_ops.launches_by_shape[(1, 1)],
             smooth_ops.launches_by_shape[(1, 3)],
             gemm_ops.launches_by_shape[(1, 1, 1)],
             seg_ops.launches_by_shape[(1, 1)])
    assert all(a > b for a, b in zip(after, before)), (before, after)
    a_new = prob.A.data * 1.2
    _, nbytes, copies = count_h2d(lambda: recompute_scalar(sd, a_new))
    assert (nbytes, copies) == (0, 0)


# ---------------------------------------------------------------------------
# The distributed slab applies (repro_torch.dist) on the card
# ---------------------------------------------------------------------------

class _StackComm:
    """One rank's view of every rank's slab, held in one process: the
    exchanges and gathers of ``repro_torch.dist.pamg`` without a process
    group (the card tests drive one rank's applies)."""

    def __init__(self, slabs, rank):
        self.slabs, self.rank, self.world = slabs, rank, len(slabs)

    def exchange(self, slab, perm):
        from types import SimpleNamespace
        src = [s for s, d in perm if d == self.rank]
        part = self.slabs[src[0]] if src else torch.zeros_like(slab)
        return SimpleNamespace(wait=lambda: part)

    def all_gather_tiled(self, x):
        return torch.cat(list(self.slabs), dim=0)


def _dist_setup(limit=0, ndev=4):
    from repro_torch.core import gamg
    from repro_torch.dist.solver import build_dist_gamg
    prob = assemble_elasticity(7, path="host", device="cpu")
    sd = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy",
                    precision="f64")
    return prob, build_dist_gamg(sd, ndev, coarse_eq_limit=limit)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("k", [0, 4])
def test_dist_window_apply_and_split_on_card(dev, level, k):
    """A slab SpMV whose indices address a halo window (``nbc != nbr``:
    level 0 on ``ppermute``, level 1 on the all-gather at 4 ranks) on
    ``block_spmv`` / ``block_spmm`` against its plain version, and the
    overlapped split apply bitwise the blocking one on every rank."""
    from repro_torch.dist import solver as ds
    _, dg = _dist_setup()
    lv = dg.levels[level]
    op = lv.a_op
    g = torch.Generator(device=dev).manual_seed(41 + level)
    tail = (k,) if k else ()
    slabs = torch.randn((dg.ndev, op.rpad, op.bc) + tail, generator=g,
                        dtype=torch.float64, device=dev)
    data = torch.randn((op.rpad, op.kmax, op.br, op.bc), generator=g,
                       dtype=torch.float64, device=dev)
    mod = spmm_ops if k else spmv_ops
    for r in range(dg.ndev):
        a = dg.rank_args(r, dev)["levels"][level]
        comm = _StackComm(slabs, r)
        win = ds.halo_window(slabs[r], op.halo, comm)
        assert win.shape[0] == op.halo.window_len != op.rpad
        got = _launch_once(mod, lambda: ds.dist_ell_apply(a["a_idx"], data,
                                                          win))
        plain = (block_spmm_ell_ref if k else block_spmv_ell_ref)(
            a["a_idx"], data, win)
        _close(got, plain)
        split = ds._rank_spmv(op, a, "a_", data, slabs[r], comm, True)
        block = ds._rank_spmv(op, a, "a_", data, slabs[r], comm, False)
        assert torch.equal(split, block)
        assert torch.equal(block, got)


@pytest.mark.parametrize("level", [0, 1])
def test_dist_stage_apply_on_card(dev, level):
    """Both Galerkin stages on ``block_pair_gemm`` + ``block_seg_sum``
    against their plain versions, the padded slot exactly 0, and stage 2
    overlapped bitwise blocking."""
    from repro_torch.dist import pamg
    _, dg = _dist_setup()
    lv = dg.levels[level]
    s1, s2 = lv.stage1, lv.stage2
    g = torch.Generator(device=dev).manual_seed(71 + level)
    for r in range(dg.ndev):
        a = dg.rank_args(r, dev)["levels"][level]
        bf = a["s1_rhs"].shape[1]
        lhs = torch.randn((s1.ppad, bf, bf), generator=g,
                          dtype=torch.float64, device=dev)
        before = (pair_ops.launches, seg_ops.launches)
        ap = pamg.dist_stage_apply(lhs, a["s1_rhs"], a["s1_off"])
        assert (pair_ops.launches, seg_ops.launches) == \
            (before[0] + 1, before[1] + 1)
        _close(ap, block_seg_sum_ref(block_pair_gemm_ref(lhs, a["s1_rhs"]),
                                     a["s1_off"]))
        assert ap.shape[0] == s1.out_pad and not ap[-1].any()
        slabs = torch.randn((dg.ndev,) + tuple(ap.shape), generator=g,
                            dtype=torch.float64, device=dev)
        slabs[:, -1] = 0                 # each AP slab's zero pad slot
        comm = _StackComm(slabs, r)
        win = pamg.halo_window(slabs[r], s2.halo, comm)
        blocking = pamg.dist_stage_apply(a["s2_lhs"], win[a["s2_rhs"]],
                                         a["s2_off"])
        _close(blocking, block_seg_sum_ref(
            block_pair_gemm_ref(a["s2_lhs"], win[a["s2_rhs"]]),
            a["s2_off"]))
        assert not blocking[-1].any()
        over = pamg.dist_stage_apply_overlap(
            a["s2_lhs"], slabs[r], s2.halo, a["s2_rhs"], a["s2_rhs_loc"],
            a["s2_msk"], a["s2_off"], comm)
        assert torch.equal(over, blocking)


@pytest.mark.parametrize("ndev", [1, 4])
def test_dist_rank_assembly_on_card(dev, ndev):
    """The rank assembly (``_rank_assemble``: the rank's element blocks,
    then one ``block_seg_sum`` launch reading them through ``perm``) at
    world 1's and world 4's rank 0 slabs, against the plain version on the
    same blocks and the CPU's slab; slots past the rank's count stay 0."""
    from repro_torch.dist import solver as ds
    from repro_torch.fem.assemble import inclusion_fields
    from repro_torch.fem.device_stiffness import DeviceAssembler, \
        element_value_stream
    prob, dg = _dist_setup(ndev=ndev)
    da = ds.build_dist_assembly(
        dg, DeviceAssembler.build(prob.mesh, prob.coo_plan, dev))
    aargs = da.rank_args(0, dev)
    E, nu = da.scatter_fields(*inclusion_fields(prob.mesh), 0, device=dev)
    slab = _launch_once(seg_ops, lambda: ds._rank_assemble(da, aargs, E,
                                                           nu))
    vals = element_value_stream(aargs["quad_b"], aargs["quad_w"], E, nu,
                                da.nn)
    _close(slab, block_seg_sum_ref(vals, aargs["offsets"], aargs["perm"]))
    nslots = int(dg.levels[0].a_nnz_starts[1])
    assert slab.shape == (da.a_pad, 3, 3) and not slab[nslots:].any()
    _close(slab, ds._rank_assemble(da, da.rank_args(0, "cpu"), E.cpu(),
                                   nu.cpu()).to(dev))


def test_nccl_world1_solve_on_card(dev, tmp_path):
    """``python -m repro_torch.dist.selftest 7 --world 1 --backend nccl``:
    the distributed recompute + solve on the card takes the single-device
    card solve's iterations, within 1e-10, launching the slab kernels."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "w1.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.selftest", "7",
         "--world", "1", "--backend", "nccl", "--device", "cuda",
         "--coarse-size", "12", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(str(np.load(out)["result"]))
    assert res["iters"] == res["iters_single"] == 9
    assert res["rel_single"] <= 1e-10
    for fam in ("block_spmv", "block_pair_gemm", "block_seg_sum"):
        assert res["launches"][fam] > 0, res["launches"]


# ---------------------------------------------------------------------------
# The LM models and the serve loop (no AMG kernel on their path)
# ---------------------------------------------------------------------------

def _lm_runs(arch, devices):
    """``arch`` at ``reduced()`` (params drawn on the CPU, copied): prefill
    logits, 3 serve steps' logits and the cache after them, at f32, on
    each device."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill, make_serve_step
    cfg = get_config(arch).reduced()
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    params = T.init_lm(cfg, 0, device="cpu")
    runs = []
    for dev in devices:
        p = T.tree_map(lambda a: a.to(dev), params)
        t = toks.to(dev)
        out = [make_prefill(cfg, torch.float32)(p, t)]
        cache = T.init_full_cache(cfg, 2, 8, torch.float32, device=dev)
        step = make_serve_step(cfg, torch.float32)
        for i in range(3):
            lg, cache = step(p, cache, t[:, i:i + 1],
                             torch.tensor(i, device=dev))
            out.append(lg)
        runs.append((out, cache))
    return runs


def _lm_leaves(tree):
    for v in tree.values():
        yield from _lm_leaves(v) if isinstance(v, dict) else (v,)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "deepseek-v2-236b"])
def test_lm_reduced_on_card_matches_cpu(dev, arch):
    """Prefill, 3 decode steps and the cache on the card against the CPU at
    f32 (the reference's tolerance, tests/test_arch_smoke.py:110); no AMG
    kernel launches."""
    mods = (seg_ops, spmv_ops, smooth_ops, gemm_ops, spmm_ops, pair_ops,
            pbj_ops)
    before = [m.launches for m in mods]
    (card, ccache), (cpu, pcache) = _lm_runs(arch, (dev, "cpu"))
    for g, w in zip(card + list(_lm_leaves(ccache)),
                    cpu + list(_lm_leaves(pcache))):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().numpy(), rtol=2e-4, atol=2e-4)
    assert [m.launches for m in mods] == before


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_lm_serve_tokens_on_card_equal_cpu(dev, arch):
    """``serve_lm.serve`` (the example's loop, prompt 8, gen 8, f32) gives
    the same greedy tokens on the card as on the CPU."""
    from repro_torch import serve_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    params = T.init_lm(cfg, 0, device="cpu")
    got = serve_lm.serve(cfg, T.tree_map(lambda a: a.to(dev), params),
                         device=dev, prompt=8, gen=8)
    want = serve_lm.serve(cfg, params, device="cpu", prompt=8, gen=8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "hymba-1.5b",
                                  "qwen2-0.5b", "falcon-mamba-7b",
                                  "whisper-small"])
def test_lm_decode_takes_no_host_sync(dev, arch):
    """A serve step whose position is a device tensor never waits for the
    card (CUDA's sync debug mode at "error"): the ring slot, the keep mask
    and the MoE dispatch stay on the device."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_serve_step
    cfg = get_config(arch).reduced()
    p = T.init_lm(cfg, 0, device=dev)
    cache = T.init_full_cache(cfg, 2, 8, torch.float32, device=dev)
    enc = None
    if cfg.encdec is not None:
        enc = torch.zeros((2, cfg.encdec.encoder_frames, cfg.d_model),
                          device=dev)
    step = make_serve_step(cfg, torch.float32)
    tok = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    pos = torch.arange(10, device=dev)
    step(p, cache, tok, pos[0], enc)                    # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, 10):                          # hymba's ring wraps
            lg, cache = step(p, cache, tok, pos[i], enc)
            tok = torch.argmax(lg, dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(lg).all()


# ---------------------------------------------------------------------------
# LM training (no AMG kernel on its path)
# ---------------------------------------------------------------------------

def test_train_step_on_card_matches_cpu(dev):
    """One f32 train step of qwen2 ``reduced()`` (params drawn on the CPU,
    copied) on the card against the CPU: the loss and ``grad_norm`` within
    1e-5 relative, each gradient leaf within 1e-4 of its largest magnitude;
    with the batch on the card the step never waits for it (CUDA's sync
    debug mode at "error"); no AMG kernel launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, SyntheticTokens
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import loss_and_grads, make_train_step
    mods = (seg_ops, spmv_ops, smooth_ops, gemm_ops, spmm_ops, pair_ops,
            pbj_ops)
    before = [m.launches for m in mods]
    cfg = get_config("qwen2-0.5b").reduced()
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                       global_batch=2, seq_len=33)).batch_at(0)
    cpu = T.init_lm(cfg, 0, device="cpu")
    runs = {}
    for d in (dev, torch.device("cpu")):
        p = T.tree_map(lambda a: a.to(d), cpu)
        b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        loss, grads = loss_and_grads(p, b, cfg, torch.float32)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), torch.float32,
                               device=d)
        opt = init_opt_state(p)
        step(p, opt, b)                                 # warm up
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, opt2, met = step(p, opt, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs[d.type] = (loss, grads, met)
        assert int(opt2["step"]) == 1
    (loss, grads, met), (wloss, wgrads, wmet) = runs["cuda"], runs["cpu"]
    for got, want in ((loss, wloss), (met["loss"], wmet["loss"]),
                      (met["grad_norm"], wmet["grad_norm"])):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(T.tree_leaves(grads), T.tree_leaves(wgrads)):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    assert [m.launches for m in mods] == before
