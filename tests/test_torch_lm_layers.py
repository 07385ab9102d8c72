"""The port's LM layers (``repro_torch.models.layers``, single blocks of
``transformer`` and ``sharding``) against the reference's twins, on the
CPU at the ``reduced()`` configs, each function under its own name.

Params come from the reference's init functions and are carried across
(``interop.lm_params_from_numpy``); inputs are drawn with numpy.  f32 at
``rtol = atol = 2e-4`` (``tests/test_arch_smoke.py:110``), bf16 at 5e-2
(``tests/test_kernels.py:41-48``).  The reference runs with jax's x64
mode off, as its own LM tests run alone (see ``test_torch_lm_model.py``).
Where the reference's activation constraints are active (``axis_env``) it
needs a mesh: a one-device mesh with the named axes, whose ``sizes`` the
env states apart, so the reference takes the same branches as on a
larger mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import sharding as RSH  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
CDT = {"f32": (torch.float32, jnp.float32, F32),
       "bf16": (torch.bfloat16, jnp.bfloat16, BF16)}
B = 2


def X32():
    return jax.enable_x64(False)


def _jit(fn):
    """The reference's ``fn`` jitted (one compile, not one per eager op),
    run with x64 off."""
    jitted = jax.jit(fn)

    def run(*args):
        with X32():
            return jitted(*args)
    return run


def _both(arch, **kw):
    """The port's and the reference's reduced config of ``arch``."""
    return (dataclasses.replace(registry.get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _carry(tree):
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


def _init(fn, cfg, seed=1):
    """A reference init (``fn(key, cfg)``) and the port's copy."""
    with X32():
        ref = jax.jit(fn, static_argnums=1)(jax.random.key(seed), cfg)
    return ref, _carry(ref)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pair(a, cdt):
    """numpy -> (torch, jax) at the compute dtype (the same rounding)."""
    tdt, jdt, _ = CDT[cdt]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a).astype(jdt)


def _mesh():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return jax.sharding.Mesh(devs, ("data", "model"))


# ---------------------------------------------------------------------------
# norms, RoPE, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", CDT)
def test_rms_norm(cdt):
    tx, jx = _pair(_x((B, 5, 64)), cdt)
    w = _x((64,), 1, 0.1)
    with X32():
        want = RL.rms_norm(jx, jnp.asarray(w), 1e-6)
    got = L.rms_norm(tx, torch.as_tensor(w), 1e-6)
    assert got.dtype == CDT[cdt][0]
    _close(got, want, CDT[cdt][2])


@pytest.mark.parametrize("cdt", CDT)
@pytest.mark.parametrize("pos", ["arange", "offset"])
def test_rope(cdt, pos):
    S = 6
    p = np.arange(S)[None] if pos == "arange" else \
        np.random.default_rng(3).integers(0, 500, (B, S))
    tx, jx = _pair(_x((B, S, 4, 16)), cdt)
    with X32():
        jc, js = RL.rope_cos_sin(jnp.asarray(p, jnp.int32), 16, 1e4)
        want = RL.apply_rope(jx, jc, js)
    tc, ts = L.rope_cos_sin(torch.as_tensor(p), 16, 1e4)
    _close(tc, jc, F32)
    _close(ts, js, F32)
    _close(L.apply_rope(tx, tc, ts), want, CDT[cdt][2])


@pytest.mark.parametrize("Sq,Sk,window,offset", [
    (8, 8, None, 0), (8, 8, 3, 0), (4, 12, None, 8), (4, 12, 5, 8),
    (1, 9, 4, 8)])
def test_causal_mask(Sq, Sk, window, offset):
    want = np.asarray(RL.causal_mask(Sq, Sk, window, offset))
    got = L.causal_mask(Sq, Sk, window, offset, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cdt", [("qwen2-0.5b", "f32"),
                                      ("qwen2-0.5b", "bf16"),
                                      ("hymba-1.5b", "f32"),
                                      ("mistral-large-123b", "f32")])
def test_attention_gqa(arch, cdt):
    """Prefill attention: QKV bias (qwen2), the sliding window (hymba's 8
    at 12 tokens)."""
    cfg, rcfg = _both(arch)
    ref, p = _init(RL.init_attention, rcfg)
    tx, jx = _pair(_x((B, 12, cfg.d_model)), cdt)
    want = _jit(lambda p, x: RL.attention_gqa(p, x, rcfg, CDT[cdt][1]))(
        ref, jx)
    _close(L.attention_gqa(p, tx, cfg, CDT[cdt][0]), want, CDT[cdt][2])


def _decode_gqa(arch, steps, cache_len, cdt="f32", pos_tensor=False):
    cfg, rcfg = _both(arch)
    tdt, jdt, tol = CDT[cdt]
    ref, p = _init(RL.init_attention, rcfg)
    S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    with X32():
        rc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt)}
    tc = {"k": torch.zeros(shape, dtype=tdt),
          "v": torch.zeros(shape, dtype=tdt)}
    xs = _x((steps, B, 1, cfg.d_model), 7)
    step = _jit(lambda p, x, c, pos: RL.attention_gqa_decode(p, x, rcfg, jdt,
                                                             c, pos))
    for pos in range(steps):
        tx, jx = _pair(xs[pos], cdt)
        want, rc = step(ref, jx, rc, jnp.asarray(pos, jnp.int32))
        got, tc2 = L.attention_gqa_decode(
            p, tx, cfg, tdt, tc, torch.tensor(pos) if pos_tensor else pos)
        assert tc2 is tc                    # written in place
        _close(got, want, tol)
        _close(tc["k"], rc["k"], tol)
        _close(tc["v"], rc["v"], tol)


def test_attention_gqa_decode_ring_buffer_wraps():
    """hymba's window of 8: 12 decode steps wrap the ring (slot pos % 8,
    every slot kept once pos >= 8), positions as device tensors."""
    _decode_gqa("hymba-1.5b", 12, 16, pos_tensor=True)


@pytest.mark.parametrize("cdt", CDT)
def test_attention_gqa_decode(cdt):
    _decode_gqa("qwen2-0.5b", 5, 8, cdt)


def test_attention_gqa_decode_past_the_cache_writes_its_last_slot():
    """Without a window, a position past the cache writes the last slot
    (the reference's clamped dynamic_update_slice) and keeps every key."""
    _decode_gqa("qwen2-0.5b", 7, 4)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", CDT)
def test_attention_mla(cdt):
    cfg, rcfg = _both("deepseek-v2-236b")
    ref, p = _init(RL.init_mla, rcfg)
    tx, jx = _pair(_x((B, 10, cfg.d_model)), cdt)
    want = _jit(lambda p, x: RL.attention_mla(p, x, rcfg, CDT[cdt][1]))(
        ref, jx)
    _close(L.attention_mla(p, tx, cfg, CDT[cdt][0]), want, CDT[cdt][2])


def test_attention_mla_decode_absorbed():
    """The absorbed decode over the compressed cache (c_kv, k_rope), 5
    steps: outputs and both caches.  f32 only: the reference's absorbed
    products do not run at bf16 on XLA's CPU backend (no BF16 x BF16 = F32
    dot, as its MoE dispatch)."""
    cdt = "f32"
    cfg, rcfg = _both("deepseek-v2-236b")
    tdt, jdt, tol = CDT[cdt]
    m = cfg.mla
    ref, p = _init(RL.init_mla, rcfg)
    with X32():
        rc = {"c_kv": jnp.zeros((B, 6, m.kv_lora_rank), jdt),
              "k_rope": jnp.zeros((B, 6, m.qk_rope_dim), jdt)}
    tc = {"c_kv": torch.zeros((B, 6, m.kv_lora_rank), dtype=tdt),
          "k_rope": torch.zeros((B, 6, m.qk_rope_dim), dtype=tdt)}
    xs = _x((5, B, 1, cfg.d_model), 9)
    step = _jit(lambda p, x, c, pos: RL.attention_mla_decode(p, x, rcfg, jdt,
                                                             c, pos))
    for pos in range(5):
        tx, jx = _pair(xs[pos], cdt)
        want, rc = step(ref, jx, rc, jnp.asarray(pos, jnp.int32))
        got, _ = L.attention_mla_decode(p, tx, cfg, tdt, tc, pos)
        _close(got, want, tol)
        _close(tc["c_kv"], rc["c_kv"], tol)
        _close(tc["k_rope"], rc["k_rope"], tol)


# ---------------------------------------------------------------------------
# FFN and MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("cdt", CDT)
def test_glu_ffn(activation, cdt):
    with X32():
        ref = RL.init_ffn(jax.random.key(2), 64, 128)
    p = _carry(ref)
    tx, jx = _pair(_x((B, 7, 64)), cdt)
    want = _jit(lambda p, x: RL.glu_ffn(p, x, activation, CDT[cdt][1]))(
        ref, jx)
    _close(L.glu_ffn(p, tx, activation, CDT[cdt][0]), want, CDT[cdt][2])


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_moe_ffn(arch, capacity):
    """Top-k routing, stable sort, capacity: at capacity factor 0.5
    assignments drop (the output differs from a dispatch with room for
    every token, in both); the shared expert is added after."""
    cfg, rcfg = _both(arch)
    mc = dataclasses.replace(cfg.moe, capacity_factor=capacity)
    roomy = dataclasses.replace(cfg.moe, capacity_factor=float(
        cfg.moe.n_experts))
    ref, p = _init(RL.init_moe, rcfg)
    assert "shared" in p
    tx, jx = _pair(_x((B, 16, cfg.d_model)), "f32")
    outs = {}
    for tag, m in (("cap", mc), ("roomy", roomy)):
        mcfg = dataclasses.replace(rcfg, moe=m)
        want = _jit(lambda p, x: RL.moe_ffn(p, x, mcfg, jnp.float32))(ref,
                                                                      jx)
        got = L.moe_ffn(p, tx, dataclasses.replace(cfg, moe=m),
                        torch.float32)
        _close(got, want, F32)
        outs[tag] = (_np(got), _np(want))
    dropped = [np.abs(outs["cap"][i] - outs["roomy"][i]).max()
               for i in range(2)]
    if capacity < 1:
        assert min(dropped) > 1e-3, dropped


def test_moe_ffn_groups_under_axis_env():
    """Under a data axis of 2, ``moe_groups`` gives G=2 and each group gets
    its own capacity, in the port as in the reference."""
    cfg, rcfg = _both("deepseek-v2-236b")
    ref, p = _init(RL.init_moe, rcfg)
    tx, jx = _pair(_x((B, 8, cfg.d_model)), "f32")
    sizes = {"data": 2, "model": 1}
    with X32(), _mesh(), RSH.axis_env(("data",), "model", sizes):
        assert RSH.moe_groups(B * 8) == 2
        want = jax.jit(lambda p, x: RL.moe_ffn(p, x, rcfg, jnp.float32))(
            ref, jx)
    with SH.axis_env(("data",), "model", sizes):
        assert SH.moe_groups(B * 8) == 2
        got = L.moe_ffn(p, tx, cfg, torch.float32)
    _close(got, want, F32)
    assert np.abs(_np(got) - _np(L.moe_ffn(p, tx, cfg, torch.float32))) \
        .max() > 0


def test_sdpa_repeat_branch_under_axis_env():
    """A model axis of 4 divides qwen2's 4 heads but not its 2 kv heads:
    ``attn_strategy`` is "repeat" and ``_sdpa`` repeats K/V, prefill and
    decode, as the reference does."""
    cfg, rcfg = _both("qwen2-0.5b")
    ref, p = _init(RL.init_attention, rcfg)
    tx, jx = _pair(_x((B, 6, cfg.d_model)), "f32")
    sizes = {"data": 1, "model": 4}
    shape = (B, 4, cfg.n_kv_heads, cfg.resolved_head_dim)
    with X32(), _mesh(), RSH.axis_env(("data",), "model", sizes):
        assert RSH.attn_strategy(4, 2) == "repeat"
        want = jax.jit(lambda p, x: RL.attention_gqa(p, x, rcfg,
                                                     jnp.float32))(ref, jx)
        wdec, _ = jax.jit(lambda p, x, c: RL.attention_gqa_decode(
            p, x, rcfg, jnp.float32, c, jnp.asarray(0, jnp.int32)))(
            ref, jx[:, :1], {"k": jnp.zeros(shape), "v": jnp.zeros(shape)})
    with SH.axis_env(("data",), "model", sizes):
        assert SH.attn_strategy(4, 2) == "repeat"
        got = L.attention_gqa(p, tx, cfg, torch.float32)
        gdec, _ = L.attention_gqa_decode(
            p, tx[:, :1], cfg, torch.float32,
            {"k": torch.zeros(shape), "v": torch.zeros(shape)}, 0)
    _close(got, want, F32)
    _close(gdec, wdec, F32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def test_causal_conv():
    cfg, rcfg = _both("falcon-mamba-7b")
    ref, p = _init(RL.init_mamba, rcfg)
    d_in = 2 * cfg.d_model
    x = _x((B, 9, d_in))
    st = _x((B, 3, d_in), 4)
    want, _ = _jit(lambda w, b, x: RL._causal_conv(x, w, b, jnp.float32))(
        ref["conv_w"], ref["conv_b"], jnp.asarray(x))
    wdec, wst = _jit(lambda w, b, x, st: RL._causal_conv(
        x, w, b, jnp.float32, st))(ref["conv_w"], ref["conv_b"],
                                   jnp.asarray(x[:, :1]), jnp.asarray(st))
    got, none = L._causal_conv(torch.as_tensor(x), p["conv_w"], p["conv_b"],
                               torch.float32)
    assert none is None
    _close(got, want, F32)
    gdec, gst = L._causal_conv(torch.as_tensor(x[:, :1]), p["conv_w"],
                               p["conv_b"], torch.float32,
                               torch.as_tensor(st))
    _close(gdec, wdec, F32)
    _close(gst, wst, F32)


@pytest.mark.parametrize("S", [16, 64, 70, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan(S, with_h0):
    """The chunked scan (chunks of 64, log-step inside): S=70 and 130 pad
    the last chunk; ``h0`` seeds it; ``h_last`` the state after S."""
    Din, N = 8, 4
    rng = np.random.default_rng(S)
    dA = np.exp(-rng.uniform(0.0, 0.2, (B, S, Din, N))).astype(np.float32)
    dBx = (rng.standard_normal((B, S, Din, N)) * 0.1).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, Din, N)).astype(np.float32) \
        if with_h0 else None
    want, wh = _jit(RL._selective_scan)(
        jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C),
        None if h0 is None else jnp.asarray(h0))
    got, gh = L._selective_scan(
        torch.as_tensor(dA), torch.as_tensor(dBx), torch.as_tensor(C),
        None if h0 is None else torch.as_tensor(h0))
    assert tuple(got.shape) == (B, S, Din)
    _close(got, want, F32)
    _close(gh, wh, F32)


@pytest.mark.parametrize("cdt", CDT)
def test_mamba_block_train_and_decode(cdt):
    """The train form at 70 tokens (the scan pads), then 4 decode steps on a
    carried state: outputs and the (conv, ssm) state."""
    cfg, rcfg = _both("falcon-mamba-7b")
    tdt, jdt, tol = CDT[cdt]
    ref, p = _init(RL.init_mamba, rcfg)
    tx, jx = _pair(_x((B, 70, cfg.d_model)), cdt)
    want, none = _jit(lambda p, x: RL.mamba_block(p, x, rcfg, jdt))(ref,
                                                                      jx)
    with X32():
        rst = RL.init_mamba_state(rcfg, B, jdt)
    got, tnone = L.mamba_block(p, tx, cfg, tdt)
    assert none is None and tnone is None
    _close(got, want, tol)
    tst = L.init_mamba_state(cfg, B, tdt, device="cpu")
    for name in rst:
        assert tst[name].dtype == {"conv": tdt, "ssm": torch.float32}[name]
    step = _jit(lambda p, x, st: RL.mamba_block(p, x, rcfg, jdt, st))
    for i in range(4):
        tx, jx = _pair(_x((B, 1, cfg.d_model), 20 + i), cdt)
        want, rst = step(ref, jx, rst)
        got, tst2 = L.mamba_block(p, tx, cfg, tdt, tst)
        assert tst2 is tst
        _close(got, want, tol)
        _close(tst["conv"], rst["conv"], tol)
        _close(tst["ssm"], rst["ssm"], tol)


# ---------------------------------------------------------------------------
# single blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "hymba-1.5b"])
def test_block_apply_and_decode(arch):
    """One stack unit (llama4's (dense, MoE) pair, deepseek's MLA + MoE,
    hymba's parallel attention / mamba with its window): prefill, then 3
    decode steps against the unit's cache."""
    cfg, rcfg = _both(arch)
    ref, p = _init(RT.init_block_unit, rcfg)
    tx, jx = _pair(_x((B, 10, cfg.d_model)), "f32")
    want = _jit(lambda p, x: RT.block_apply(p, x, rcfg, jnp.float32))(ref,
                                                                        jx)
    with X32():
        rc = RT.init_layer_cache(rcfg, B, 6, jnp.float32)
    _close(T.block_apply(p, tx, cfg, torch.float32), want, F32)
    tc = T.init_layer_cache(cfg, B, 6, torch.float32, device="cpu")
    step = _jit(lambda p, x, c, pos: RT.block_decode(p, x, rcfg,
                                                     jnp.float32, c, pos))
    for pos in range(3):
        tx, jx = _pair(_x((B, 1, cfg.d_model), 30 + pos), "f32")
        want, rc = step(ref, jx, rc, jnp.asarray(pos, jnp.int32))
        got, _ = T.block_decode(p, tx, cfg, torch.float32, tc, pos)
        _close(got, want, F32)
        flat_r = jax.tree_util.tree_leaves_with_path(rc)
        for path, leaf in flat_r:
            node = tc
            for k in path:
                node = node[k.key]
            _close(node, leaf, F32)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

ENVS = [(None, None, None), (("data",), "model", {"data": 2, "model": 4}),
        (("pod", "data"), "model", {"pod": 2, "data": 3, "model": 2}),
        (("data",), "model", {"data": 4, "model": 5}),
        (("data",), "model", {"data": 16, "model": 16})]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_attn_strategy_and_moe_groups(env):
    batch_axes, model_axis, sizes = ENVS[env]
    heads = [(14, 2), (25, 5), (12, 12), (32, 8), (4, 2), (96, 8)]
    tokens = [1, 2, 6, 12, 32, 4096]
    got, want = [], []
    for mod, out in ((SH, got), (RSH, want)):
        with mod.axis_env(batch_axes, model_axis, sizes):
            out.append([mod.attn_strategy(h, k) for h, k in heads])
            out.append([mod.moe_groups(t) for t in tokens])
    assert got == want
    assert SH._ACTIVE["batch_axes"] is None      # restored on exit


def test_constrain_is_the_identity_on_one_card():
    x = torch.ones(2, 3, 4)
    with SH.axis_env(("data",), "model", {"data": 2, "model": 2}):
        for kind in ("btd", "btf", "logits"):
            assert SH.constrain(x, kind) is x
        assert SH.constrain_heads(x, 2, seq_axis=1) is x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_partition_specs(arch):
    """Every param's spec, as a tuple, equals the reference's
    ``PartitionSpec``, under the default and other axis names."""
    cfg, rcfg = _both(arch)
    with X32():
        ref = jax.eval_shape(lambda: RT.init_lm(rcfg, jax.random.key(0)))
    port = T.init_lm(cfg, 0, device="cpu")
    for axes in (("data", "model"), (("pod", "data"), "tp")):
        want = RSH.tree_partition_specs(ref, *axes)
        flat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)
        )[0]
        want = {"/".join(k.key for k in path): tuple(spec)
                for path, spec in flat}
        assert _flat(SH.tree_partition_specs(port, *axes)) == want


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
