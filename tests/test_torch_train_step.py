"""The port's train step (``repro_torch.train.steps``: ``loss_fn`` under
``loss_and_grads``, ``make_train_step``) against the reference's, on the
CPU at every architecture's ``reduced()`` config.

The reference's params are carried across (``interop.lm_params_from_numpy``)
and the batch is ``SyntheticTokens.batch_at`` (B=2, S=32, as
``tests/test_arch_smoke.py``); the reference runs with jax's x64 mode off.
Tolerances:

* ``loss_fn`` and its gradients (``jax.value_and_grad`` against
  ``loss_and_grads``) at f32: the loss within 1e-5 relative, each gradient
  leaf within 1e-4 of that leaf's largest magnitude.  A leaf whose
  gradient is zero in exact arithmetic is rounding noise in both packages:
  llama4's router (top-1 gates renormalize to exactly 1) gives 2e-9 of the
  tree's largest gradient in the reference.  Such a leaf (largest
  magnitude under 1e-6 of the tree's) is held below 1e-6 of the tree's
  largest gradient in both packages instead.
* the same at bf16 compute within 5e-2, for the archs whose reference runs
  and agrees there: the reference's bf16 MoE dispatch raises on XLA's CPU
  (llama4, deepseek); hymba's ``dt_proj`` gradient differs by 6.1e-2 of
  its largest (the dt path through bf16 products), so hymba is held at
  f32 only.
* ``make_train_step`` over 3 steps: losses and ``grad_norm`` within 1e-4
  relative (Adam turns gradient sign noise into parameter steps of 2 lr,
  so raw parameters after independent steps are not compared).

deepseek, hymba and llama4 are ``slow``, as the reference marks their
training (``tests/test_arch_smoke.py:28``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro.train.data import DataConfig, SyntheticTokens  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

B, SEQ = 2, 32
LOSS_REL, GRAD_REL, BF16_REL, STEP_REL = 1e-5, 1e-4, 5e-2, 1e-4
NOISE = 1e-6
SLOW = {"deepseek-v2-236b", "hymba-1.5b", "llama4-maverick-400b-a17b"}
BF16_ARCHS = [a for a in ARCH_IDS if a not in SLOW]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _arch_params(archs):
    return [pytest.param(a, marks=pytest.mark.slow) if a in SLOW else a
            for a in archs]


def X32():
    return jax.enable_x64(False)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's params (jax), the port's copy and the batch."""
    cfg = get_config(arch).reduced()
    with X32():
        ref = jax.jit(RT.init_lm, static_argnums=0)(cfg, jax.random.key(0))
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=B,
                    seq_len=SEQ + 1,
                    enc_frames=cfg.encdec.encoder_frames if cfg.encdec else 0,
                    d_model=cfg.d_model)
    return ref, jax.tree_util.tree_map(np.asarray, ref), \
        SyntheticTokens(dc).batch_at(0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _assert_grads_close(got, want, rel):
    got = dict(T.tree_leaves_with_path(got))
    want = {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want)
    top = max(np.abs(_np(w)).max() for w in want.values())
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        assert g.shape == w.shape, k
        scale = np.abs(w).max()
        if scale < NOISE * top:
            assert np.abs(g).max() < NOISE * top, k
            continue
        err = np.abs(g - w).max() / scale
        assert err <= rel, ("/".join(k), err)


def _loss_and_grads(arch, cdt):
    ref, ref_np, batch = _setup(arch)
    cfg = get_config(arch).reduced()
    with X32():
        rloss, rgrads = jax.jit(jax.value_and_grad(RS.loss_fn),
                                static_argnums=(2, 3))(
            ref, {k: jnp.asarray(v) for k, v in batch.items()}, cfg,
            JDT[cdt])
    params = lm_params_from_numpy(ref_np, device="cpu")
    loss, grads = S.loss_and_grads(
        params, {k: torch.as_tensor(v) for k, v in batch.items()},
        registry.get_config(arch).reduced(), cdt)
    return (float(loss), grads), (float(rloss), rgrads)


@pytest.mark.parametrize("arch", _arch_params(ARCH_IDS))
def test_loss_and_grads_match_the_reference_f32(arch):
    (loss, grads), (rloss, rgrads) = _loss_and_grads(arch, torch.float32)
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - rloss) <= LOSS_REL * rloss, (loss, rloss)
    _assert_grads_close(grads, rgrads, GRAD_REL)
    assert all(g.dtype == torch.float32 for g in T.tree_leaves(grads))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_loss_and_grads_match_the_reference_bf16(arch):
    """bf16 compute (the default): fp32 master gradients through the
    casts."""
    (loss, grads), (rloss, rgrads) = _loss_and_grads(arch, torch.bfloat16)
    assert abs(loss - rloss) <= BF16_REL * rloss, (loss, rloss)
    _assert_grads_close(grads, rgrads, BF16_REL)
    assert all(g.dtype == torch.float32 for g in T.tree_leaves(grads))


@pytest.mark.parametrize("arch", _arch_params(
    ["qwen2-0.5b", "falcon-mamba-7b", "whisper-small", "hymba-1.5b"]))
def test_train_step_losses_match_over_three_steps(arch):
    """Three ``make_train_step`` steps from the same params on the same
    batches (numpy, placed by the step): losses and global norms."""
    ref, ref_np, _ = _setup(arch)
    rcfg, cfg = get_config(arch).reduced(), \
        registry.get_config(arch).reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=B,
                    seq_len=SEQ + 1,
                    enc_frames=cfg.encdec.encoder_frames if cfg.encdec else 0,
                    d_model=cfg.d_model)
    data = SyntheticTokens(dc)
    with X32():
        rstep = jax.jit(RS.make_train_step(rcfg, RO.AdamWConfig(lr=1e-3),
                                           cdt=jnp.float32))
        ropt = RO.init_opt_state(ref)
        want = []
        for i in range(3):
            b = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            ref, ropt, m = rstep(ref, ropt, b)
            want.append((float(m["loss"]), float(m["grad_norm"])))
    params = lm_params_from_numpy(ref_np, device="cpu")
    opt = O.init_opt_state(params)
    step = S.make_train_step(cfg, O.AdamWConfig(lr=1e-3), torch.float32,
                             device="cpu")
    for i in range(3):
        params, opt, m = step(params, opt, data.batch_at(i))
        assert m["loss"].ndim == 0 and m["grad_norm"].ndim == 0
        for got, w in zip((float(m["loss"]), float(m["grad_norm"])),
                          want[i]):
            assert abs(got - w) <= STEP_REL * abs(w), (i, got, w)
    assert int(opt["step"]) == int(ropt["step"]) == 3


def test_loss_decreases_briefly():
    """The reference's own criterion (``tests/test_arch_smoke.py:142``) on
    the port: qwen2 ``reduced()``, lr 3e-3, warmup 5, 12 steps."""
    cfg = registry.get_config("qwen2-0.5b").reduced()
    params = T.init_lm(cfg, 5, "cpu")
    opt = O.init_opt_state(params)
    step = S.make_train_step(cfg, O.AdamWConfig(lr=3e-3, warmup_steps=5),
                             torch.float32, device="cpu")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      global_batch=4, seq_len=33))
    losses = []
    for i in range(12):
        params, opt, m = step(params, opt, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


def test_train_step_leaves_its_inputs_and_moves_every_param():
    """The step is functional (its input params and state unchanged) and
    every leaf moves; ``loss_and_grads`` gives zeros, not ``None``, for a
    leaf that does not reach the loss."""
    cfg = registry.get_config("qwen2-0.5b").reduced()
    params = T.init_lm(cfg, 1, "cpu")
    before = T.tree_map(torch.clone, params)
    opt = O.init_opt_state(params)
    step = S.make_train_step(cfg, O.AdamWConfig(lr=1e-3), torch.float32,
                             device="cpu")
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                       global_batch=2, seq_len=9)).batch_at(0)
    new, opt2, _ = step(params, opt, batch)
    assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(params),
                                                 T.tree_leaves(before)))
    assert int(opt["step"]) == 0 and int(opt2["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(T.tree_leaves(new),
                                                     T.tree_leaves(params)))
    extra = dict(params, unused=torch.ones(3))
    _, grads = S.loss_and_grads(
        extra, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg,
        torch.float32)
    assert torch.equal(grads["unused"], torch.zeros(3))


def test_unstacked_layers_are_the_indexed_views():
    """``forward_train`` takes each layer's params by one ``unbind`` a
    leaf: the same views as indexing the stack."""
    cfg = registry.get_config("llama4-maverick-400b-a17b").reduced()
    blocks = T.init_lm(cfg, 0, "cpu")["blocks"]
    parts = T._unstack(blocks, T._n_units(cfg))
    assert len(parts) == T._n_units(cfg)
    for i, part in enumerate(parts):
        want = T._layer(blocks, i)
        for (pa, a), (pb, b) in zip(T.tree_leaves_with_path(part),
                                    T.tree_leaves_with_path(want)):
            assert pa == pb and torch.equal(a, b)
            assert a.data_ptr() == b.data_ptr()
