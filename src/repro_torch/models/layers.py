"""Model layers: norms, RoPE, GQA/MLA attention, GLU FFN, MoE, Mamba
(torch twin of ``repro.models.layers``).

Functional torch (nested dicts of tensors + apply functions), each function
under the reference's name.  Conventions, as the reference's:

* params are fp32 masters; compute casts them to ``cdt`` at use sites;
  softmax and scan accumulations run in fp32.  Where the reference asks a
  product of ``cdt`` operands for an fp32 result
  (``preferred_element_type``), both operands are upcast to fp32 first: a
  bf16 product is exact in fp32, so the arithmetic is the same.
* activations are (B, S, D); attention internals (B, S, H, hd).
* every layer has a decode form for one new token; it writes the cache
  (or state) it is given in place and returns it.  ``pos`` is an ``int``
  or a 0-d device tensor; with a tensor the ring slot and the keep mask
  are computed on the device (no host sync a token).
* init functions draw from a ``torch.Generator`` and put the tensors on
  its device; the scales are the reference's, the values are not (jax's
  random bits are not reproduced: carry the reference's params across
  with ``repro_torch.interop.lm_params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, \
    SSMConfig
from repro_torch.models.sharding import attn_strategy, constrain, \
    moe_groups

Params = Dict[str, Any]
NEG = -1e30                 # masked score (the reference's)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, scale_dim=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(scale_dim if scale_dim else shape[0])
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _zeros(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def _pos(pos, device) -> torch.Tensor:
    """An ``int`` or a tensor position as a 0-d int64 tensor on
    ``device``."""
    return torch.as_tensor(pos, device=device).to(torch.int64)


def _mm32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b, preferred_element_type=f32)``."""
    return torch.einsum(eq, a.float(), b.float())


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., dim/2) in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B?, S, hd/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": _dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": _dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, cfg.n_heads * hd)
        p["bk"] = _zeros(gen, cfg.n_kv_heads * hd)
        p["bv"] = _zeros(gen, cfg.n_kv_heads * hd)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], n_kv_heads: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention; softmax in fp32.

    q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd); H = G*Hkv.  Under an ``axis_env``
    whose TP degree divides H but not Hkv (``attn_strategy`` "repeat"), K/V
    are repeated to H heads, as the reference does; otherwise the query
    heads are grouped over the kv heads.
    """
    B, Sq, H, hd = q.shape
    G = H // n_kv_heads
    if attn_strategy(H, n_kv_heads) == "repeat":
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
        scores = _mm32("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[:, None], scores, NEG)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return _mm32("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
    qg = q.reshape(B, Sq, n_kv_heads, G, hd)
    scores = _mm32("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = _mm32("bhgqk,bkhd->bqhgd", probs, v).to(q.dtype)
    return ctx.reshape(B, Sq, H, hd)


def causal_mask(Sq: int, Sk: int, window: Optional[int] = None,
                offset: int = 0, device="cuda") -> torch.Tensor:
    """(1, Sq, Sk) boolean keep-mask on ``device``: causal + optional
    sliding window.

    ``offset`` = absolute position of query 0 minus key 0.
    """
    dev = resolve_device(device)
    qpos = torch.arange(Sq, device=dev)[:, None] + offset
    kpos = torch.arange(Sk, device=dev)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep[None]


def _positions(S: int, positions, device) -> torch.Tensor:
    return positions if positions is not None else \
        torch.arange(S, device=device)[None]


def attention_gqa(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training/prefill attention (causal, optional sliding window)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, cdt)
    cos, sin = rope_cos_sin(_positions(S, positions, x.device), hd,
                            cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mask = causal_mask(S, S, cfg.sliding_window, device=x.device)
    ctx = _sdpa(q, k, v, mask, cfg.n_kv_heads)
    return ctx.reshape(B, S, -1) @ p["wo"].to(cdt)


def attention_gqa_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                         cache: Dict[str, torch.Tensor], pos
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with a (possibly ring/sliding) KV cache.

    cache: {"k","v": (B, Scache, Hkv, hd)}, written in place; pos: absolute
    position.  For sliding-window configs the cache length is the window
    and writes wrap modulo the window (ring buffer); otherwise a position
    past the cache writes its last slot (the reference's clamped update).
    """
    B, S1, _ = x.shape
    assert S1 == 1
    hd = cfg.resolved_head_dim
    pos = _pos(pos, x.device)
    q, k, v = _qkv(p, x, cfg, cdt)
    cos, sin = rope_cos_sin(pos[None, None], hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    Sc = cache["k"].shape[1]
    kpos = torch.arange(Sc, device=x.device)
    if cfg.sliding_window is None:
        slot = pos.clamp(0, Sc - 1)
        keep = kpos <= pos
    else:  # ring buffer: everything in the cache is within the window
        slot = pos % Sc
        keep = (kpos <= pos) | (pos >= Sc)
    cache["k"].index_copy_(1, slot.reshape(1), k)
    cache["v"].index_copy_(1, slot.reshape(1), v)
    mask = keep[None, None].expand(B, 1, Sc)
    ctx = _sdpa(q, cache["k"], cache["v"], mask, cfg.n_kv_heads)
    y = ctx.reshape(B, 1, -1) @ p["wo"].to(cdt)
    return y, cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": _dense_init(gen, (d, m.q_lora_rank)),
        "q_norm": _zeros(gen, m.q_lora_rank),
        "wq_b": _dense_init(gen, (m.q_lora_rank, H * qk)),
        "wkv_a": _dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_dim)),
        "kv_norm": _zeros(gen, m.kv_lora_rank),
        "wk_b": _dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_dim)),
        "wv_b": _dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim)),
        "wo": _dense_init(gen, (H * m.v_head_dim, d)),
    }


def attention_mla(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training/prefill MLA: latent-compressed KV, decoupled RoPE keys."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q = rms_norm(x @ p["wq_a"].to(cdt), p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"].to(cdt)).reshape(B, S, H,
                                        m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    kv = x @ p["wkv_a"].to(cdt)
    c_kv, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_nope = (c_kv @ p["wk_b"].to(cdt)).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p["wv_b"].to(cdt)).reshape(B, S, H, m.v_head_dim)
    cos, sin = rope_cos_sin(_positions(S, positions, x.device),
                            m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # shared head
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (_mm32("bqhd,bkhd->bhqk", q_nope, k_nope)
              + _mm32("bqhd,bkod->bhqk", q_rope, k_rope)) * scale
    mask = causal_mask(S, S, device=x.device)
    scores = torch.where(mask[:, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    ctx = _mm32("bhqk,bkhd->bqhd", probs, v).to(cdt)
    return ctx.reshape(B, S, -1) @ p["wo"].to(cdt)


def attention_mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                         cache: Dict[str, torch.Tensor], pos
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matrix MLA decode over the *compressed* cache.

    cache: {"c_kv": (B, Sc, kv_lora), "k_rope": (B, Sc, rope_dim)}, written
    in place.  Per-head K/V are never materialized: W_uk is absorbed into
    the query and W_uv applied after the latent context (arXiv:2405.04434
    Sec. 2.1).
    """
    m: MLAConfig = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos = _pos(pos, x.device)
    q = rms_norm(x @ p["wq_a"].to(cdt), p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"].to(cdt)).reshape(B, 1, H,
                                        m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    kv = x @ p["wkv_a"].to(cdt)
    c_new, kr_new = torch.split(kv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_new = rms_norm(c_new, p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(pos[None, None], m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr_new = apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Sc = c_kv.shape[1]
    slot = pos.clamp(0, Sc - 1).reshape(1)
    c_kv.index_copy_(1, slot, c_new)
    k_rope.index_copy_(1, slot, kr_new)
    # absorb W_uk into the query: q_eff (B,1,H,kv_lora)
    wk_b = p["wk_b"].to(cdt).reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_eff = _mm32("bqhd,chd->bqhc", q_nope, wk_b).to(cdt)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (_mm32("bqhc,bkc->bhqk", q_eff, c_kv)
              + _mm32("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    keep = torch.arange(Sc, device=x.device)[None, None, None] <= pos
    scores = torch.where(keep, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(cdt)
    ctx_c = _mm32("bhqk,bkc->bqhc", probs, c_kv).to(cdt)
    wv_b = p["wv_b"].to(cdt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    ctx = _mm32("bqhc,chd->bqhd", ctx_c, wv_b).to(cdt)
    y = ctx.reshape(B, 1, -1) @ p["wo"].to(cdt)
    return y, cache


# ---------------------------------------------------------------------------
# GLU FFN
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, d_model: int, d_ff: int) -> Params:
    return {"w_gate": _dense_init(gen, (d_model, d_ff)),
            "w_up": _dense_init(gen, (d_model, d_ff)),
            "w_down": _dense_init(gen, (d_ff, d_model))}


def glu_ffn(p: Params, x: torch.Tensor, activation: str, cdt
            ) -> torch.Tensor:
    g = x @ p["w_gate"].to(cdt)
    if activation == "swiglu":
        h = F.silu(g) * (x @ p["w_up"].to(cdt))
    elif activation == "geglu":
        h = F.gelu(g, approximate="tanh") * (x @ p["w_up"].to(cdt))
    else:
        h = F.gelu(g, approximate="tanh")   # plain GELU: no up projection
    return h @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# MoE (sort-based, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    mc: MoEConfig = cfg.moe
    d, dff = cfg.d_model, mc.d_ff_expert or cfg.d_ff
    p = {"router": _dense_init(gen, (d, mc.n_experts)),
         "we_gate": _dense_init(gen, (mc.n_experts, d, dff), scale_dim=d),
         "we_up": _dense_init(gen, (mc.n_experts, d, dff), scale_dim=d),
         "we_down": _dense_init(gen, (mc.n_experts, dff, d),
                                scale_dim=dff)}
    if mc.n_shared:
        p["shared"] = init_ffn(gen, d, cfg.d_ff)
    return p


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt
            ) -> torch.Tensor:
    """Grouped token-choice top-k with capacity (GShard/MegaBlocks shape).

    Tokens split into G groups (``moe_groups``: the data shards of the
    active axis env, else 1); each group routes top-k (gates renormalized),
    sorts its assignments by expert (stable) and dispatches them into its
    (E, C_g, d) slice, C_g = max(1, int(capacity_factor * T_g * k / E)).
    Assignments past an expert's capacity are dropped on dispatch and read
    back as 0; the combine adds each assignment's gated output to its
    token; the shared expert is added after.  C_g depends on the token
    count, so prefill and decode drop different assignments.
    """
    mc: MoEConfig = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = mc.top_k, mc.n_experts
    G = moe_groups(T)
    Tg = T // G
    Cg = max(1, int(mc.capacity_factor * Tg * k / E))
    xf = x.reshape(T, d)
    xg = constrain(x.reshape(G, Tg, d), "btd")
    logits = (xg @ p["router"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)            # (G, Tg, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    tok_of = order // k                                   # (G, Tg*k)
    experts = torch.arange(E, device=x.device).expand(G, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)        # (G, E)
    pos_in_e = (torch.arange(Tg * k, device=x.device)[None]
                - torch.gather(starts, 1, sorted_e))
    payload = torch.gather(xg, 1, tok_of[..., None].expand(G, Tg * k, d))
    # dispatch into (G, E*Cg + 1, d): over-capacity assignments land on the
    # last (discarded) row, which is also the zero row read back for them
    slot = torch.where(pos_in_e < Cg, sorted_e * Cg + pos_in_e, E * Cg)
    buf = torch.zeros((G, E * Cg + 1, d), dtype=cdt, device=x.device)
    buf.scatter_(1, slot[..., None].expand(G, Tg * k, d), payload)
    h = buf[:, :E * Cg].reshape(G, E, Cg, d)
    g = _mm32("gecd,edf->gecf", h, p["we_gate"].to(cdt)).to(cdt)
    u = _mm32("gecd,edf->gecf", h, p["we_up"].to(cdt)).to(cdt)
    o = _mm32("gecf,efd->gecd", F.silu(g) * u,
              p["we_down"].to(cdt)).to(cdt)
    o = torch.cat([o.reshape(G, E * Cg, d),
                   torch.zeros((G, 1, d), dtype=cdt, device=x.device)], 1)
    per_assign = torch.gather(o, 1, slot[..., None].expand(G, Tg * k, d))
    gate_sorted = torch.gather(gates.reshape(G, Tg * k), 1, order).to(cdt)
    contrib = per_assign * gate_sorted[..., None]
    out = torch.zeros((G, Tg, d), dtype=cdt, device=x.device)
    out.scatter_add_(1, tok_of[..., None].expand(G, Tg * k, d), contrib)
    out = constrain(out, "btd").reshape(T, d)
    if mc.n_shared:
        out = out + glu_ffn(p["shared"], xf, cfg.activation, cdt)
    return out.reshape(B, S, d)


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    sc: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = sc.expand * d
    dtr = sc.resolved_dt_rank(d)
    A = torch.arange(1, sc.d_state + 1, dtype=torch.float32,
                     device=gen.device).expand(d_in, sc.d_state)
    return {
        "in_proj": _dense_init(gen, (d, 2 * d_in)),
        "conv_w": _dense_init(gen, (sc.d_conv, d_in), scale_dim=sc.d_conv),
        "conv_b": _zeros(gen, d_in),
        "x_proj": _dense_init(gen, (d_in, dtr + 2 * sc.d_state)),
        "dt_proj": _dense_init(gen, (dtr, d_in)),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32,
                              device=gen.device),        # softplus ~ 0.01
        "A_log": torch.log(A),
        "D": torch.ones(d_in, dtype=torch.float32, device=gen.device),
        "out_proj": _dense_init(gen, (d_in, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cdt,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  x (B,S,Din); w (K,Din).  With
    ``state`` (B, K-1, Din), the decode form: returns the output and the
    next state."""
    K = w.shape[0]
    if state is not None:                       # decode: x is (B,1,Din)
        window = torch.cat([state, x], dim=1)           # (B,K,Din)
        y = torch.einsum("bkd,kd->bd", window, w.to(cdt)) + b.to(cdt)
        return y[:, None], window[:, 1:]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = pad[:, 0:S] * w[0].to(cdt)
    for i in range(1, K):
        y = y + pad[:, i:i + S] * w[i].to(cdt)
    return y + b.to(cdt), None


def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the combine (a1, b1) . (a2, b2) =
    (a1 a2, b1 a2 + b2), in log2(len) Hillis-Steele steps."""
    n, s = a.shape[1], 1
    while s < n:
        a_cur = a[:, s:]
        b = torch.cat([b[:, :s], b[:, :-s] * a_cur + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a_cur], dim=1)
        s *= 2
    return a, b


def _selective_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, chunk: int = 64):
    """h_t = dA_t * h_{t-1} + dBx_t ;  y_t = <h_t, C_t>.

    dA, dBx: (B, S, Din, N); C: (B, S, N).  Chunked: a sequential loop over
    S/chunk chunks (S padded with dA = 1, dBx = C = 0), a log-step scan
    inside each chunk.  Returns y (B, S, Din) and the last state h_last
    (B, Din, N).
    """
    B, S, Din, N = dA.shape
    if S % chunk:
        pad = chunk - S % chunk
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBx = F.pad(dBx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    h = torch.zeros((B, Din, N), dtype=dA.dtype, device=dA.device) \
        if h0 is None else h0
    ys = []
    for c0 in range(0, dA.shape[1], chunk):
        aa, bb = _scan_chunk(dA[:, c0:c0 + chunk], dBx[:, c0:c0 + chunk])
        h_t = aa * h[:, None] + bb                    # (B, chunk, Din, N)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_t, C[:, c0:c0 + chunk]))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """Mamba-1 block.  Training (state=None; returns (y, None)) or
    single-token decode (``state`` {"conv", "ssm"} written in place;
    returns (y, state))."""
    sc: SSMConfig = cfg.ssm
    dtr = sc.resolved_dt_rank(x.shape[-1])
    xz = x @ p["in_proj"].to(cdt)
    xi, z = xz.chunk(2, dim=-1)
    if state is None:
        xi, _ = _causal_conv(xi, p["conv_w"], p["conv_b"], cdt)
    else:
        xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], cdt,
                                      state["conv"])
        state["conv"].copy_(conv_state)
    xi = F.silu(xi)
    proj = xi @ p["x_proj"].to(cdt)
    dt, Bc, Cc = torch.split(proj, [dtr, sc.d_state, sc.d_state], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"].to(cdt)).float()
                    + p["dt_bias"])                   # (B,S,Din) fp32
    A = -torch.exp(p["A_log"])                        # (Din,N)
    dA = torch.exp(dt[..., None] * A)                 # (B,S,Din,N)
    dBx = (dt * xi.float())[..., None] \
        * Bc.float()[:, :, None, :]                   # (B,S,Din,N)
    if state is None:
        y, _ = _selective_scan(dA, dBx, Cc.float())
    else:
        h = state["ssm"] * dA[:, 0] + dBx[:, 0]
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].float())[:, None]
        state["ssm"].copy_(h)
    y = (y + xi.float() * p["D"]).to(cdt)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(cdt), state


def init_mamba_state(cfg: ModelConfig, batch: int, cdt, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    sc: SSMConfig = cfg.ssm
    d_in = sc.expand * cfg.d_model
    return {"conv": torch.zeros((batch, sc.d_conv - 1, d_in), dtype=cdt,
                                device=dev),
            "ssm": torch.zeros((batch, d_in, sc.d_state),
                               dtype=torch.float32, device=dev)}
