"""Serve-step builders (torch twin of the serving half of
``repro.train.steps``).

``make_prefill``      causal forward producing logits for a prompt batch.

``make_serve_step``   one-token decode against a seq_len cache.

``make_init``         the param tree of ``transformer.init_lm``.

Both steps run under ``torch.inference_mode()``; the compute dtype is
bf16 by default, as the reference's.  ``cross_entropy``, ``loss_fn`` and
``make_train_step`` (with the optimizer and the backward pass) are not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill(cfg: ModelConfig, cdt=torch.bfloat16):
    """prefill(params, tokens[, enc_feats]) -> logits (B, S, V)."""

    @torch.inference_mode()
    def prefill(params, tokens, enc_feats=None):
        return T.forward_train(params, tokens, cfg, cdt, remat=False,
                               enc_feats=enc_feats)

    return prefill


def make_serve_step(cfg: ModelConfig, cdt=torch.bfloat16):
    """serve_step(params, cache, token, pos[, enc_out]) -> (logits, cache).

    ``cache`` is the stacked (L, ...) decode cache of ``init_full_cache``
    with capacity seq_len, written in place; ``pos`` the absolute position
    of the new token (an ``int`` or a 0-d device tensor).
    """

    @torch.inference_mode()
    def serve_step(params, cache, token, pos, enc_out=None):
        return T.decode_step(params, token, pos, cache, cfg, cdt,
                             enc_out=enc_out)

    return serve_step


def make_init(cfg: ModelConfig, device="cuda"):
    """init(seed) -> the param tree on ``device``."""

    def init(seed: int = 0):
        return T.init_lm(cfg, seed, device)

    return init
