"""Decoder stacks (dense/MoE/MLA/SSM/hybrid) + the Whisper-style enc-dec
(torch twin of ``repro.models.transformer``).

Layers are homogeneous per architecture, so parameters are *stacked* along
a leading L axis (the reference's tree: a nested dict of tensors, the same
keys; (dense, MoE) pair units under ``"a"`` / ``"b"`` when interleaved).
The layers run in a Python loop over L.  Training (autograd recording)
wraps each layer in ``torch.utils.checkpoint`` (full remat per layer);
prefill and serving run under ``torch.inference_mode()``
(``repro_torch.train.steps``).  Decode threads a stacked cache through
the same loop and writes it in place.  ``LM`` holds the tree as an
``nn.Module``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _stack(make: Callable[[], Params], n: int) -> Params:
    """``n`` results of ``make()`` stacked along a new leading axis, filled
    one unit at a time (the stack plus one unit at the peak)."""
    first = make()
    out = tree_map(lambda a: a.new_empty((n,) + a.shape), first)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    for i in range(n):
        fill(out, first if i == 0 else make(), i)
    return out


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _interleaved(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and cfg.moe.moe_every == 2


def _n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // (2 if _interleaved(cfg) else 1)


def init_block(gen: torch.Generator, cfg: ModelConfig,
               use_moe: Optional[bool] = None) -> Params:
    if use_moe is None:
        use_moe = cfg.moe is not None
    p: Params = {"ln1": L._zeros(gen, cfg.d_model)}
    if cfg.attention == "mla":
        p["attn"] = L.init_mla(gen, cfg)
    elif cfg.attention == "gqa":
        p["attn"] = L.init_attention(gen, cfg)
    if cfg.ssm is not None:
        p["mamba"] = L.init_mamba(gen, cfg)
    if cfg.family != "ssm":                     # ssm blocks have no FFN
        p["ln2"] = L._zeros(gen, cfg.d_model)
        p["ffn"] = (L.init_moe(gen, cfg) if use_moe
                    else L.init_ffn(gen, cfg.d_model, cfg.d_ff))
    if cfg.hybrid_parallel_ssm:
        # Hymba-style per-branch output norms for the parallel fusion
        p["attn_out_norm"] = L._zeros(gen, cfg.d_model)
        p["ssm_out_norm"] = L._zeros(gen, cfg.d_model)
    return p


def init_block_unit(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Stack unit: one block, or a (dense, MoE) pair when interleaved."""
    if _interleaved(cfg):
        return {"a": init_block(gen, cfg, use_moe=False),
                "b": init_block(gen, cfg, use_moe=True)}
    return init_block(gen, cfg)


def _mixer(p: Params, h: torch.Tensor, cfg: ModelConfig, cdt
           ) -> torch.Tensor:
    """Sequence mixer (attention / mamba / parallel hybrid), train form."""
    if cfg.hybrid_parallel_ssm:
        a = L.attention_gqa(p["attn"], h, cfg, cdt)
        m, _ = L.mamba_block(p["mamba"], h, cfg, cdt)
        return 0.5 * (L.rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                      + L.rms_norm(m, p["ssm_out_norm"], cfg.norm_eps))
    if cfg.family == "ssm":
        m, _ = L.mamba_block(p["mamba"], h, cfg, cdt)
        return m
    if cfg.attention == "mla":
        return L.attention_mla(p["attn"], h, cfg, cdt)
    return L.attention_gqa(p["attn"], h, cfg, cdt)


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, cdt) -> torch.Tensor:
    # the param structure records whether this sub-block routes (MoE)
    return (L.moe_ffn(p["ffn"], h, cfg, cdt) if "router" in p["ffn"]
            else L.glu_ffn(p["ffn"], h, cfg.activation, cdt))


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt
                ) -> torch.Tensor:
    if "a" in p and "ln1" not in p:             # interleaved pair unit
        x = block_apply(p["a"], x, cfg, cdt)
        return block_apply(p["b"], x, cfg, cdt)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + constrain(_mixer(p, h, cfg, cdt), "btd")
    if cfg.family == "ssm":
        return x
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + constrain(_ffn(p, h, cfg, cdt), "btd")


def block_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
                 cache: Dict[str, torch.Tensor], pos
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block's decode step; ``cache`` (one unit's) written in place."""
    if "a" in p and "ln1" not in p:             # interleaved pair unit
        x, _ = block_decode(p["a"], x, cfg, cdt, cache["a"], pos)
        x, _ = block_decode(p["b"], x, cfg, cdt, cache["b"], pos)
        return x, cache
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.hybrid_parallel_ssm:
        a, _ = L.attention_gqa_decode(p["attn"], h, cfg, cdt, cache, pos)
        m, _ = L.mamba_block(p["mamba"], h, cfg, cdt, cache)
        mix = 0.5 * (L.rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                     + L.rms_norm(m, p["ssm_out_norm"], cfg.norm_eps))
    elif cfg.family == "ssm":
        mix, _ = L.mamba_block(p["mamba"], h, cfg, cdt, cache)
    elif cfg.attention == "mla":
        mix, _ = L.attention_mla_decode(p["attn"], h, cfg, cdt, cache, pos)
    else:
        mix, _ = L.attention_gqa_decode(p["attn"], h, cfg, cdt, cache, pos)
    x = x + mix
    if cfg.family != "ssm":
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(p, h, cfg, cdt)
    return x, cache


def init_layer_cache(cfg: ModelConfig, batch: int, seq_len: int, cdt,
                     _unit: bool = True, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """One stack unit's decode cache for a maximum context of
    ``seq_len``."""
    dev = resolve_device(device)
    if _unit and _interleaved(cfg):
        one = init_layer_cache(cfg, batch, seq_len, cdt, _unit=False,
                               device=dev)
        return {"a": one, "b": tree_map(torch.clone, one)}
    hd = cfg.resolved_head_dim
    c: Dict[str, torch.Tensor] = {}
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        c.update(L.init_mamba_state(cfg, batch, cdt, device=dev))
    if cfg.family != "ssm":
        if cfg.attention == "mla":
            m = cfg.mla
            c.update(
                c_kv=torch.zeros((batch, seq_len, m.kv_lora_rank),
                                 dtype=cdt, device=dev),
                k_rope=torch.zeros((batch, seq_len, m.qk_rope_dim),
                                   dtype=cdt, device=dev))
        else:
            s = (min(seq_len, cfg.sliding_window)
                 if cfg.sliding_window else seq_len)
            c.update(
                k=torch.zeros((batch, s, cfg.n_kv_heads, hd), dtype=cdt,
                              device=dev),
                v=torch.zeros((batch, s, cfg.n_kv_heads, hd), dtype=cdt,
                              device=dev))
    return c


# ---------------------------------------------------------------------------
# stacked decoder LM
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """The reference's param tree (keys, shapes, fp32), drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    block_init = (init_decoder_block if cfg.encdec is not None
                  else init_block_unit)     # enc-dec: self + cross + ffn
    p = {"embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                scale_dim=cfg.d_model),
         "blocks": _stack(lambda: block_init(gen, cfg), _n_units(cfg)),
         "ln_f": L._zeros(gen, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size))
    if cfg.encdec is not None:
        p["encoder"] = init_encoder(gen, cfg)
    return p


def _embed(p: Params, tokens: torch.Tensor, cdt) -> torch.Tensor:
    # gather, then cast: the reference's cast-then-gather, elementwise
    return p["embed"][tokens].to(cdt)


def _unembed(p: Params, x: torch.Tensor, cfg: ModelConfig, cdt
             ) -> torch.Tensor:
    w = (p["embed"].T if cfg.tie_embeddings else p["lm_head"]).to(cdt)
    return constrain(x @ w, "logits")


def forward_train(p: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  cdt=torch.bfloat16, remat: bool = True,
                  enc_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V).  A loop over the stacked layers,
    each checkpointed when ``remat`` and autograd is recording."""
    x = constrain(_embed(p, tokens, cdt), "btd")
    if cfg.encdec is not None:
        enc_out = encoder_apply(p["encoder"], enc_feats, cfg, cdt)

        def body(h, bp):
            return decoder_block_apply(bp, h, enc_out, cfg, cdt)
    else:
        def body(h, bp):
            return block_apply(bp, h, cfg, cdt)
    remat = remat and torch.is_grad_enabled()
    for i in range(_n_units(cfg)):
        bp = _layer(p["blocks"], i)
        x = checkpoint(body, x, bp, use_reentrant=False) if remat \
            else body(x, bp)
    x = L.rms_norm(x, p["ln_f"], cfg.norm_eps)
    return _unembed(p, x, cfg, cdt)


def init_full_cache(cfg: ModelConfig, batch: int, seq_len: int,
                    cdt=torch.bfloat16, device="cuda") -> Dict:
    """The stacked (L, ...) decode cache, zeros, capacity ``seq_len``."""
    one = init_layer_cache(cfg, batch, seq_len, cdt, device=device)
    return tree_map(lambda a: a.new_zeros((_n_units(cfg),) + a.shape), one)


def decode_step(p: Params, token: torch.Tensor, pos, cache: Dict,
                cfg: ModelConfig, cdt=torch.bfloat16,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token against a cache of ``seq_len`` context (serve_step).

    token (B, 1) integer; pos the absolute position, an ``int`` or a 0-d
    device tensor (no host sync); cache stacked (L, ...), written in place
    and returned.
    """
    x = _embed(p, token, cdt)
    pos = L._pos(pos, x.device)
    for i in range(_n_units(cfg)):
        bp, lc = _layer(p["blocks"], i), _layer(cache, i)
        if cfg.encdec is not None:
            x, _ = decoder_block_decode(bp, x, enc_out, cfg, cdt, lc, pos)
        else:
            x, _ = block_decode(bp, x, cfg, cdt, lc, pos)
    x = L.rms_norm(x, p["ln_f"], cfg.norm_eps)
    return _unembed(p, x, cfg, cdt), cache


# ---------------------------------------------------------------------------
# encoder-decoder (Whisper-style backbone; conv frontend is a stub)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {"wq": L._dense_init(gen, (d, cfg.n_heads * hd)),
            "wk": L._dense_init(gen, (d, cfg.n_heads * hd)),
            "wv": L._dense_init(gen, (d, cfg.n_heads * hd)),
            "wo": L._dense_init(gen, (cfg.n_heads * hd, d))}


def cross_attention(p: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig, cdt) -> torch.Tensor:
    B, Sq, _ = x.shape
    Sk = enc.shape[1]
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"].to(cdt)).reshape(B, Sq, cfg.n_heads, hd)
    k = (enc @ p["wk"].to(cdt)).reshape(B, Sk, cfg.n_heads, hd)
    v = (enc @ p["wv"].to(cdt)).reshape(B, Sk, cfg.n_heads, hd)
    ctx = L._sdpa(q, k, v, None, cfg.n_heads)
    return ctx.reshape(B, Sq, -1) @ p["wo"].to(cdt)


def init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    e = cfg.encdec

    def enc_block():
        return {"ln1": L._zeros(gen, cfg.d_model),
                "attn": L.init_attention(gen, cfg),
                "ln2": L._zeros(gen, cfg.d_model),
                "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff)}

    return {"pos_embed": L._dense_init(gen, (e.encoder_frames,
                                             cfg.d_model)),
            "blocks": _stack(enc_block, e.n_encoder_layers),
            "ln_f": L._zeros(gen, cfg.d_model)}


def encoder_apply(p: Params, feats: torch.Tensor, cfg: ModelConfig, cdt
                  ) -> torch.Tensor:
    """feats (B, frames, d): precomputed frame embeddings (stub
    frontend)."""
    x = feats.to(cdt) + p["pos_embed"].to(cdt)[None]
    B, S, _ = x.shape
    for i in range(cfg.encdec.n_encoder_layers):
        bp = _layer(p["blocks"], i)
        a = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        # bidirectional attention: no mask
        q, k, v = L._qkv(bp["attn"], a, cfg, cdt)
        ctx = L._sdpa(q, k, v, None, cfg.n_kv_heads)
        x = x + ctx.reshape(B, S, -1) @ bp["attn"]["wo"].to(cdt)
        f = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.glu_ffn(bp["ffn"], f, "gelu", cdt)
    return L.rms_norm(x, p["ln_f"], cfg.norm_eps)


def init_decoder_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": L._zeros(gen, cfg.d_model),
            "attn": L.init_attention(gen, cfg),
            "ln_x": L._zeros(gen, cfg.d_model),
            "xattn": init_cross_attention(gen, cfg),
            "ln2": L._zeros(gen, cfg.d_model),
            "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff)}


def decoder_block_apply(p: Params, x: torch.Tensor, enc: torch.Tensor,
                        cfg: ModelConfig, cdt) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.attention_gqa(p["attn"], h, cfg, cdt)
    h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    x = x + cross_attention(p["xattn"], h, enc, cfg, cdt)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.glu_ffn(p["ffn"], h, "gelu", cdt)


def decoder_block_decode(p: Params, x: torch.Tensor, enc: torch.Tensor,
                         cfg: ModelConfig, cdt,
                         cache: Dict[str, torch.Tensor], pos
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, _ = L.attention_gqa_decode(p["attn"], h, cfg, cdt, cache, pos)
    x = x + mix
    h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    x = x + cross_attention(p["xattn"], h, enc, cfg, cdt)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.glu_ffn(p["ffn"], h, "gelu", cdt), cache


def init_encdec_lm(cfg: ModelConfig, seed: int = 0, device="cuda"
                   ) -> Params:
    """Whisper-style enc-dec (alias: init_lm dispatches on cfg.encdec)."""
    return init_lm(cfg, seed, device)


def count_params(params) -> int:
    if isinstance(params, nn.Module):
        return sum(a.numel() for a in params.parameters())
    return sum(v.numel() if not isinstance(v, dict) else count_params(v)
               for v in params.values())


# ---------------------------------------------------------------------------
# nn.Module form
# ---------------------------------------------------------------------------

def _as_module(tree: Params) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _as_module(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


def _as_tree(mod: nn.Module) -> Params:
    return {k: _as_tree(v) if isinstance(v, nn.ParameterDict) else v
            for k, v in mod.items()}


class LM(nn.Module):
    """The stacked LM as an ``nn.Module``: the param tree in nested
    ``nn.ParameterDict``s, so ``state_dict()`` keys are the reference's
    paths joined by ``.`` (``blocks.attn.wq``).  ``params`` (a tree, e.g.
    carried across) or ``init_lm(cfg, seed, device)``'s."""

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None,
                 cdt=torch.bfloat16, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg, self.cdt = cfg, cdt
        if params is None:
            params = init_lm(cfg, seed, device)
        for k, v in params.items():
            if isinstance(v, dict):
                setattr(self, k, _as_module(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def params(self) -> Params:
        """The param tree (the module's own parameters, not copies)."""
        return {k: _as_tree(v) if isinstance(v, nn.ParameterDict) else v
                for k, v in list(self.named_parameters(recurse=False))
                + list(self.named_children())}

    def forward(self, tokens: torch.Tensor,
                enc_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward_train(self.params(), tokens, self.cfg, self.cdt,
                             enc_feats=enc_feats)

    def decode(self, token: torch.Tensor, pos, cache: Dict,
               enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
        return decode_step(self.params(), token, pos, cache, self.cfg,
                           self.cdt, enc_out=enc_out)
