"""What the ``fused_smoother`` wrappers hand the C entry points, on the
CPU: the lanes map's value, the unchanged ``threads``, the payload check
and the knob set.  The kernel itself, every lanes value and the C entries'
refusals are held on the card by ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune, backend, ell_rows  # noqa: E402
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.fused_smoother.ref import \
    smoother_step_ref  # noqa: E402

#: (bs, kmax): the m=32 level operators A0, A1, A2 and short rows
SHAPES = [(3, 27), (6, 45), (6, 490), (3, 1), (3, 7), (6, 3)]


def _operands(bs, kmax, k=None, nbr=5, seed=0, data=None):
    """Smoother operands: ``(indices, data, dinv, b, x, d, coef)``; a
    ``(nbr, bs, k)`` panel when ``k`` is given."""
    rng = np.random.default_rng(seed)
    cols = () if k is None else (k,)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape))
    idx = torch.as_tensor(rng.integers(0, nbr, (nbr, kmax)),
                          dtype=torch.int32)
    data = t(nbr, kmax, bs, bs) if data is None else data
    return (idx, data, t(nbr, bs, bs), t(nbr, bs, *cols), t(nbr, bs, *cols),
            t(nbr, bs, *cols), torch.tensor([0.3, 0.7], dtype=torch.float64))


def _launched(monkeypatch, call):
    """Run the wrapper as if its tensors were on the card, capturing the C
    entry point's arguments instead of launching."""
    seen = []
    monkeypatch.setattr(smooth_ops, "launches", smooth_ops.launches)
    monkeypatch.setattr(backend, "on_cuda", lambda name, **t: True)
    monkeypatch.setattr(backend, "launch",
                        lambda name, argtypes, *args: seen.append(
                            (name, len(argtypes), args)))
    call()
    (name, nargs, args), = seen
    # every argument but the stream, which ``launch`` appends
    assert nargs == len(args) + 1
    return name, args


@pytest.mark.parametrize("bs,kmax", SHAPES)
@pytest.mark.parametrize("threads", [32, 256, 512])
def test_smoother_wrappers_pass_the_lanes_map(monkeypatch, bs, kmax,
                                              threads):
    want = ell_rows.lanes(bs, bs, kmax)
    args = _operands(bs, kmax, seed=bs + kmax)
    name, got = _launched(monkeypatch, lambda: smooth_ops.smoother_step_ell(
        *args, threads=threads))
    assert name == "repro_fused_smoother_f64"
    assert got[9:] == (5, kmax, bs, want, threads)
    for k in (1, 16):
        args = _operands(bs, kmax, k=k, seed=bs + kmax + k)
        name, got = _launched(monkeypatch,
                              lambda: smooth_ops.smoother_step_ell(
                                  *args, threads=threads))
        assert name == "repro_fused_smoother_panel_f64"
        assert got[1] is None and got[10:] == (5, kmax, bs, k, want,
                                               threads)


def test_smoother_takes_block_spmv_lanes(monkeypatch):
    """One ``lanes`` call per step, on the operator's shape: the value
    ``block_spmv`` takes on the same operator."""
    calls = []
    orig = ell_rows.lanes

    def spy(*a):
        calls.append(a)
        return orig(*a)
    monkeypatch.setattr(ell_rows, "lanes", spy)
    _launched(monkeypatch, lambda: smooth_ops.smoother_step_ell(
        *_operands(6, 490)))
    _launched(monkeypatch, lambda: smooth_ops.smoother_step_ell(
        *_operands(3, 27, k=4)))
    assert calls == [(6, 6, 490), (3, 3, 27)]


def test_launch_lanes_passes_an_explicit_lanes(monkeypatch):
    """The sweep's entry: any lanes value goes to the C entry as given (it
    refuses a bad one on the card), and no launch is counted."""
    for lanes, k in ((1, None), (8, None), (32, 3), (12, 16)):
        args = _operands(6, 9, k=k)
        before = smooth_ops.launches
        name, got = _launched(monkeypatch, lambda: smooth_ops.launch_lanes(
            *args, lanes, 128))
        assert got[-2:] == (lanes, 128)
        assert name == ("repro_fused_smoother_f64" if k is None
                        else "repro_fused_smoother_panel_f64")
        assert smooth_ops.launches == before


@pytest.mark.parametrize("bs,k", [(6, 16), (6, 2), (3, 16), (6, None)])
def test_smoother_step_hands_the_ell_lengths_to_the_panel_entry(
        monkeypatch, bs, k):
    """``smoother_step`` passes its ELL's lengths: their pointer as the
    panel entry's second argument (a null one for a raw operator), none to
    the vector entry; the launch is counted under the body the C source's
    rule picks (staged: 6x6 blocks, k > 1)."""
    from repro_torch.core.block_csr import BlockELL
    idx, data, dinv, b, x, d, coef = _operands(bs, 9, k=k, nbr=6, seed=k or 0)
    lengths = torch.tensor([9, 0, 3, 1, 9, 5], dtype=torch.int32)
    ell = BlockELL(indices=idx, data=data, mask=torch.ones(idx.shape,
                                                           dtype=torch.bool),
                   nbc=6, lengths=lengths)
    flat = (lambda v: v.reshape(6 * bs, -1) if k else v.reshape(-1))
    monkeypatch.setattr(smooth_ops, "launches_by_body",
                        dict.fromkeys(smooth_ops.launches_by_body, 0))
    name, got = _launched(monkeypatch, lambda: smooth_ops.smoother_step(
        ell, dinv, flat(b), flat(x), flat(d), coef))
    if k is None:
        assert name == "repro_fused_smoother_f64" and len(got) == 14
        assert lengths.data_ptr() not in got
    else:
        assert name == "repro_fused_smoother_panel_f64" and len(got) == 16
        assert got[:2] == (idx.data_ptr(), lengths.data_ptr())
    want = "staged" if bs == 6 and k and k > 1 else "sub_warp"
    assert smooth_ops.launches_by_body == {
        b: int(b == want) for b in ("sub_warp", "staged")}
    raw = _operands(bs, 9, k=k or 2, nbr=6)
    _, got = _launched(monkeypatch, lambda: smooth_ops.smoother_step_ell(
        *raw))
    assert got[1] is None


def test_smoother_refuses_lengths_of_another_shape(monkeypatch):
    args = _operands(6, 9, k=4, nbr=6)
    for bad in (torch.zeros(5, dtype=torch.int32),
                torch.zeros(6, dtype=torch.int64)):
        with pytest.raises(ValueError):
            _launched(monkeypatch, lambda: smooth_ops.smoother_step_ell(
                *args, lengths=bad))


@pytest.mark.parametrize("bs", [3, 6])
def test_misaligned_smoother_payloads_raise_before_the_launch(monkeypatch,
                                                              bs):
    """6x6 blocks are read in 16-byte pairs: a payload view 8 bytes off an
    allocation is refused before any launch; 3x3 passes."""
    nbr, kmax = 5, 3
    flat = torch.zeros(1 + nbr * kmax * bs * bs, dtype=torch.float64)
    data = flat[1:].view(nbr, kmax, bs, bs)
    assert data.is_contiguous() and data.data_ptr() % 16 == 8
    for k in (None, 4):
        args = _operands(bs, kmax, k=k, data=data)
        call = (lambda args=args: smooth_ops.smoother_step_ell(*args))
        if bs % 2:
            _launched(monkeypatch, call)
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _launched(monkeypatch, call)


def test_smoother_knob_set_is_threads():
    assert set(autotune.CANDIDATES["fused_smoother"]) == {"threads"}


@pytest.mark.parametrize("k", [None, 3])
def test_cpu_smoother_ignores_lengths(k):
    """The plain version walks every slot (padded blocks are zero), so
    ``lengths`` changes nothing on the CPU."""
    args = _operands(6, 45, k=k, nbr=7)
    lengths = torch.tensor([45, 0, 1, 7, 45, 30, 2], dtype=torch.int32)
    for g, w in zip(smooth_ops.smoother_step_ell(*args, lengths=lengths),
                    smoother_step_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [None, 3])
def test_cpu_smoother_counts_no_launch(k):
    """On CPU tensors the wrapper takes the plain version and counts
    nothing."""
    args = _operands(6, 45, k=k, nbr=7)
    before = smooth_ops.launches
    got = smooth_ops.smoother_step_ell(*args)
    assert smooth_ops.launches == before
    for g, w in zip(got, smoother_step_ref(*args)):
        assert torch.equal(g, w)
