"""AdamW with global-norm clipping + optional int8 gradient compression
(torch twin of ``repro.train.optimizer``).

Optimizer state is fp32 (m, v) regardless of param dtype, with a 0-d int32
``step`` on the params' device (read on the device: no host sync a step).
The update is the reference's as it stands: clip by the global norm, the
learning rate from the *pre-increment* step, bias corrections from the
*post-increment* step, then ``p - lr * (dir + wd * p)`` (not
``torch.optim.AdamW``, which has no clip or warmup and decays as
``p *= 1 - lr * wd``).  Leaves are visited in jax's order (dict keys sorted
at every level): the global norm's sum and the pairing of leaves follow it.

Gradient compression (``compress_grads``) is chunked int8 quantization with
error feedback for the data-parallel reduce; ``torch.round`` rounds half to
even, as ``jnp.round`` does.  It is exercised by tests and off by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> Dict[str, Any]:
    """f32 zero moments like every leaf and a 0-d int32 step, on the params'
    device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """Returns (new_params, new_state, grad_norm)."""
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    lr = _schedule(cfg, state["step"])
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / b1c
        vh = v / b2c
        step_dir = mh / (torch.sqrt(vh) + cfg.eps)
        p32 = p.float()
        new_p = p32 - lr * (step_dir + cfg.weight_decay * p32)
        return new_p.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm


# ---------------------------------------------------------------------------
# int8 chunked gradient compression with error feedback
# ---------------------------------------------------------------------------

def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x


@torch.no_grad()
def compress_grads(grads, err, chunk: int = 1024):
    """Quantize each leaf to int8 with per-chunk scales; carry residual.

    Returns (q_tree {q, scale, shape}, new_err).  Decompress with
    ``decompress_grads``.  Error feedback makes the scheme unbiased over
    steps (Seide et al.; 1-bit Adam lineage).
    """
    def one(g, e):
        g32 = g.float() + e
        n = g32.numel()
        pad = (-n) % chunk
        flat = F.pad(g32.reshape(-1), (0, pad)).reshape(-1, chunk)
        scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(flat / scale), -127, 127) \
            .to(torch.int8)
        deq = (q.float() * scale).reshape(-1)[:n].reshape(g.shape)
        return {"q": q, "scale": scale, "shape": tuple(g.shape)}, g32 - deq

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def decompress_grads(qtree):
    def one(d):
        n = 1
        for s in d["shape"]:
            n *= s
        flat = (d["q"].float() * d["scale"]).reshape(-1)[:n]
        return flat.reshape(d["shape"])

    return {k: one(v) if _is_q(v) else decompress_grads(v)
            for k, v in qtree.items()}


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
