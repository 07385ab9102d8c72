"""Train and serve step builders (torch twin of ``repro.train.steps``).

``make_train_step``   forward (per-layer ``torch.utils.checkpoint``) ->
                      fp32 token-mean cross-entropy -> ``torch.autograd``
                      backward -> AdamW update.

``make_prefill``      causal forward producing logits for a prompt batch.

``make_serve_step``   one-token decode against a seq_len cache.

``make_init``         the param tree of ``transformer.init_lm``.

The compute dtype is bf16 by default, as the reference's; the fp32
masters receive fp32 gradients through the ``.to(cdt)`` casts.  The serve
steps run under ``torch.inference_mode()`` (their outputs cannot be saved
for a backward pass).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig, apply_updates


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Token-mean xent in fp32; labels < 0 are masked.

    The label logit is a gather where the reference contracts with a
    one-hot (its vocab dim is sharded over "model", where a gather would
    all-gather the logits).  On one card it is the same function, and the
    one-hot would cost B*S*V floats: 622 MB in fp32 at qwen2's 151,936
    vocab with B=4 and S=256, and as much again for its gradient.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - ll) * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cdt=torch.bfloat16) -> torch.Tensor:
    logits = T.forward_train(params, batch["tokens"], cfg, cdt,
                             enc_feats=batch.get("enc_feats"))
    return cross_entropy(logits, batch["labels"])


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   cdt=torch.bfloat16) -> Tuple[torch.Tensor, Any]:
    """``loss_fn``'s value and its gradient tree (``jax.value_and_grad``):
    every leaf's gradient, zeros where a leaf does not reach the loss."""
    leaves = T.tree_map(lambda a: a.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch, cfg, cdt)
        grads = torch.autograd.grad(loss, T.tree_leaves(leaves),
                                    materialize_grads=True)
    return loss.detach(), T.tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    cdt=torch.bfloat16, device="cuda"):
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics),
    ``metrics`` {"loss", "grad_norm"} as 0-d device tensors.  The batch's
    arrays (numpy or tensors) are put on ``device``, where the params
    must be."""
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(params, batch, cfg, cdt)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


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
