"""The port's whole LM models (``repro_torch.models.transformer``, the serve
steps and ``repro_torch.serve_lm``) against the reference's, on the CPU at
every architecture's ``reduced()`` config.

The reference's params are carried across (``interop.lm_params_from_numpy``)
and its outputs computed once per arch (module-level cache): prefill
logits, the whisper encoder, 3 decode steps (logits and cache).  f32 at
``rtol = atol = 2e-4`` (``tests/test_arch_smoke.py:110``), bf16 at 5e-2
(``tests/test_kernels.py:41-48``).  Decode is held to prefill for the
non-MoE archs only: the MoE capacity depends on the token count, so the
reference's own prefill and decode drop different assignments.

The reference runs with jax's x64 mode off (``X32``), as its own LM tests
run alone: other test files turn it on (``repro.core``), and under it the
reference's ``_dense_init`` promotes its params to f64 (an f32 normal
times a numpy f64 scale).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import steps as RS  # noqa: E402

from repro_torch import serve_lm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import lm_cache_from_numpy, \
    lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import steps  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
B, S, CACHE, DECODE = 2, 16, 8, 3
MOE_ARCHS = {"llama4-maverick-400b-a17b", "deepseek-v2-236b"}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def X32():
    return jax.enable_x64(False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_tree_close(got, want, tol):
    got, want = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k,
                                   **tol)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    feats = None
    if cfg.encdec is not None:
        feats = rng.standard_normal((B, cfg.encdec.encoder_frames,
                                     cfg.d_model)).astype(np.float32)
    return toks, feats


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's reduced params (jax) and the port's copy (CPU)."""
    cfg = get_config(arch).reduced()
    with X32():
        ref = jax.jit(RT.init_lm, static_argnums=0)(cfg, jax.random.key(0))
    return ref, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                     device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch, cdt=torch.float32):
    """The reference's prefill logits, encoder output and ``DECODE`` serve
    steps (logits, then the cache after them), as numpy."""
    with X32():
        return _run_reference(arch, cdt)


def _run_reference(arch, cdt):
    cfg = get_config(arch).reduced()
    ref, _ = _params(arch)
    jdt = JDT[cdt]
    toks, feats = _inputs(cfg)
    feats = None if feats is None else jnp.asarray(feats)
    logits = jax.jit(RS.make_prefill(cfg, cdt=jdt))(
        ref, jnp.asarray(toks, jnp.int32), feats)
    enc = None if feats is None else RT.encoder_apply(ref["encoder"], feats,
                                                      cfg, jdt)
    step = jax.jit(RS.make_serve_step(cfg, cdt=jdt))
    cache = RT.init_full_cache(cfg, B, CACHE, cdt=jdt)
    dec = []
    for pos in range(DECODE):
        lg, cache = step(ref, cache, jnp.asarray(toks[:, pos:pos + 1],
                                                 jnp.int32),
                         jnp.asarray(pos, jnp.int32), enc)
        dec.append(_np(lg))
    return dict(logits=_np(logits), enc=None if enc is None else _np(enc),
                decode=dec, cache=cache)


def _port_run(arch, cdt):
    cfg = registry.get_config(arch).reduced()
    _, params = _params(arch)
    toks, feats = _inputs(cfg)
    feats = None if feats is None else torch.as_tensor(feats)
    logits = steps.make_prefill(cfg, cdt)(params, torch.as_tensor(toks),
                                          feats)
    enc = None
    if feats is not None:
        with torch.inference_mode():
            enc = T.encoder_apply(params["encoder"], feats, cfg, cdt)
    step = steps.make_serve_step(cfg, cdt)
    cache = T.init_full_cache(cfg, B, CACHE, cdt=cdt, device="cpu")
    dec = []
    for pos in range(DECODE):
        lg, cache = step(params, cache, torch.as_tensor(toks[:, pos:pos + 1]),
                         pos, enc)
        dec.append(_np(lg))
    return dict(logits=_np(logits), enc=None if enc is None else _np(enc),
                decode=dec, cache=cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_lm_tree_equals_the_reference(arch):
    """Keys, shapes and dtypes of ``init_lm`` (and of the decode cache)
    equal the reference's; ``count_params`` too."""
    cfg = registry.get_config(arch).reduced()
    ref, _ = _params(arch)
    got = _flat(T.init_lm(cfg, 0, device="cpu"))
    want = _flat(ref)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == torch.float32 and w.dtype == jnp.float32, k
    assert T.count_params(T.init_lm(cfg, 0, device="cpu")) == \
        RT.count_params(ref)
    for cdt in (torch.float32, torch.bfloat16):
        gc = _flat(T.init_full_cache(cfg, B, CACHE, cdt, device="cpu"))
        wc = _flat(RT.init_full_cache(get_config(arch).reduced(), B, CACHE,
                                      JDT[cdt]))
        assert sorted(gc) == sorted(wc)
        for k, w in wc.items():
            assert tuple(gc[k].shape) == w.shape, k
            assert str(gc[k].dtype).split(".")[-1] == str(w.dtype), k


def test_init_lm_is_seeded():
    cfg = registry.get_config("qwen2-0.5b").reduced()
    a, b = T.init_lm(cfg, 3, "cpu"), T.init_lm(cfg, 3, "cpu")
    c = steps.make_init(cfg, device="cpu")(4)
    assert all(torch.equal(x, y) for x, y in zip(_flat(a).values(),
                                                 _flat(b).values()))
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill logits, the whisper encoder, 3 serve steps' logits and the
    cache after them, at f32, against the reference's."""
    want, got = _reference(arch), _port_run(arch, torch.float32)
    np.testing.assert_allclose(got["logits"], want["logits"], **F32)
    if want["enc"] is not None:
        np.testing.assert_allclose(got["enc"], want["enc"], **F32)
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g, w, **F32)
    _assert_tree_close(got["cache"], want["cache"], F32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-small"])
def test_bf16_matches_the_reference(arch):
    """bf16 compute (the serve steps' default) against the reference at
    bf16.  The reference's MoE dispatch does not run at bf16 on XLA's CPU
    backend (no BF16 x BF16 = F32 dot), so deepseek's bf16 MLA is held in
    ``test_torch_lm_layers.py`` and its MoE at f32."""
    want, got = _reference(arch, torch.bfloat16), \
        _port_run(arch, torch.bfloat16)
    np.testing.assert_allclose(got["logits"], want["logits"], **BF16)
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g, w, **BF16)
    _assert_tree_close(got["cache"], want["cache"], BF16)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in MOE_ARCHS])
def test_decode_matches_prefill(arch):
    """Token-by-token decode reproduces the causal prefill's logits (12
    tokens: hymba's window-8 ring buffer wraps)."""
    cfg = registry.get_config(arch).reduced()
    _, params = _params(arch)
    toks, feats = _inputs(cfg)
    toks = torch.as_tensor(toks[:, :12])
    feats = None if feats is None else torch.as_tensor(feats)
    full = steps.make_prefill(cfg, torch.float32)(params, toks, feats)
    enc = None
    if feats is not None:
        with torch.inference_mode():
            enc = T.encoder_apply(params["encoder"], feats, cfg,
                                  torch.float32)
    step = steps.make_serve_step(cfg, torch.float32)
    cache = T.init_full_cache(cfg, B, 12, torch.float32, device="cpu")
    for pos in range(12):
        lg, cache = step(params, cache, toks[:, pos:pos + 1],
                         torch.tensor(pos), enc)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, pos]), **F32)


def test_moe_decode_differs_from_prefill_as_the_reference():
    """The MoE capacity depends on the token count: llama4's decode (2
    tokens a step, capacity 1) drops assignments its 32-token prefill keeps,
    in the port as in the reference.  The port's 16 decode steps equal the
    reference's; both differ from prefill by more than 1e-2."""
    arch = "llama4-maverick-400b-a17b"
    cfg = registry.get_config(arch).reduced()
    ref, params = _params(arch)
    toks, _ = _inputs(cfg)
    rcfg = get_config(arch).reduced()
    want, got = [], []
    with X32():
        step = jax.jit(RS.make_serve_step(rcfg, cdt=jnp.float32))
        cache = RT.init_full_cache(rcfg, B, S, cdt=jnp.float32)
        for i in range(S):
            lg, cache = step(ref, cache,
                             jnp.asarray(toks[:, i:i + 1], jnp.int32),
                             jnp.asarray(i, jnp.int32))
            want.append(_np(lg)[:, 0])
    pstep = steps.make_serve_step(cfg, torch.float32)
    pcache = T.init_full_cache(cfg, B, S, torch.float32, device="cpu")
    for i in range(S):
        lg, pcache = pstep(params, pcache, torch.as_tensor(toks[:, i:i + 1]),
                           i)
        got.append(_np(lg)[:, 0])
    want, got = np.stack(want, 1), np.stack(got, 1)
    np.testing.assert_allclose(got, want, **F32)
    full = steps.make_prefill(cfg, torch.float32)(params,
                                                  torch.as_tensor(toks))
    np.testing.assert_allclose(_np(full), _reference(arch)["logits"], **F32)
    assert np.abs(want - _reference(arch)["logits"]).max() > 1e-2
    assert np.abs(got - _np(full)).max() > 1e-2


def test_lm_module_matches_the_functions():
    """``LM`` holds the tree: ``state_dict`` keys are the reference's paths
    joined by '.', ``forward`` is ``forward_train`` and ``decode`` is
    ``decode_step`` on the same params."""
    arch = "llama4-maverick-400b-a17b"           # pair units, MoE
    cfg = registry.get_config(arch).reduced()
    ref, params = _params(arch)
    lm = T.LM(cfg, params, cdt=torch.float32)
    assert sorted(lm.state_dict()) == sorted(
        k.replace("/", ".") for k in _flat(ref))
    assert T.count_params(lm) == RT.count_params(ref)
    toks, _ = _inputs(cfg)
    toks = torch.as_tensor(toks)
    with torch.inference_mode():
        got = lm(toks)
        want = T.forward_train(params, toks, cfg, torch.float32)
        assert torch.equal(got, want)
        c1 = T.init_full_cache(cfg, B, CACHE, torch.float32, device="cpu")
        c2 = T.init_full_cache(cfg, B, CACHE, torch.float32, device="cpu")
        l1, c1 = lm.decode(toks[:, :1], 0, c1)
        l2, c2 = T.decode_step(params, toks[:, :1], 0, c2, cfg,
                               torch.float32)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(_flat(c1).values(),
                                                 _flat(c2).values()))
    np.testing.assert_allclose(_np(got), _reference(arch)["logits"], **F32)


def test_lm_module_trains_through_checkpointed_layers():
    """With autograd recording, ``forward`` checkpoints each layer and the
    gradient reaches every parameter (the remat path)."""
    cfg = registry.get_config("qwen2-0.5b").reduced()
    lm = T.LM(cfg, T.init_lm(cfg, 1, "cpu"), cdt=torch.float32)
    toks = torch.as_tensor(_inputs(cfg)[0])
    lm(toks).square().mean().backward()
    grads = {k: p.grad for k, p in lm.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    assert float(grads["blocks.attn.wq"].abs().max()) > 0


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_serve_tokens_equal_the_reference_loop(arch):
    """``serve_lm.serve`` on carried params generates the reference's greedy
    tokens (the example's loop through ``make_serve_step``, prompt 8,
    gen 8)."""
    prompt, gen = 8, 8
    cfg = get_config(arch).reduced()
    ref, params = _params(arch)
    with X32():
        step = jax.jit(RS.make_serve_step(cfg, cdt=jnp.float32))
        cache = RT.init_full_cache(cfg, serve_lm.B, prompt + gen,
                                   cdt=jnp.float32)
        prompts = jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (serve_lm.B, prompt)), jnp.int32)
        for pos in range(prompt):
            logits, cache = step(ref, cache, prompts[:, pos:pos + 1],
                                 jnp.asarray(pos, jnp.int32))
        toks = [jnp.argmax(logits, axis=-1).astype(jnp.int32)]
        for pos in range(prompt, prompt + gen - 1):
            logits, cache = step(ref, cache, toks[-1],
                                 jnp.asarray(pos, jnp.int32))
            toks.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
        want = np.concatenate([np.asarray(t) for t in toks], axis=1)
    got = serve_lm.serve(registry.get_config(arch).reduced(), params,
                         device="cpu", prompt=prompt, gen=gen)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["tok_per_s"] > 0


def test_serve_lm_main_runs_both_models_on_the_cpu(capsys):
    out = serve_lm.main(device="cpu")
    assert list(out["models"]) == list(serve_lm.ARCHS)
    for res in out["models"].values():
        assert np.asarray(res["tokens"]).shape == (serve_lm.B, serve_lm.GEN)
    assert "tok/s incl. prefill" in capsys.readouterr().out


def test_carried_cache_crosses_bitwise():
    """``lm_cache_from_numpy`` keeps each leaf's dtype (bf16 by its bit
    pattern)."""
    cfg = get_config("hymba-1.5b").reduced()
    cache = RT.init_full_cache(cfg, B, CACHE, cdt=jnp.bfloat16)
    cache = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3, a.dtype), cache)
    got = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cache),
                              device="cpu")
    assert got["k"].dtype == torch.bfloat16
    assert got["ssm"].dtype == torch.float32
    _assert_tree_close(got, cache, dict(rtol=0, atol=0))
