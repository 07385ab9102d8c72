"""Activation-sharding hooks and parameter partition specs (torch twin of
``repro.models.sharding``).

The launch layer activates axis names for the batch- and model-parallel
dimensions (``axis_env``).  On one card there is no mesh to constrain
activations to, so ``constrain`` and ``constrain_heads`` are the identity.
What the active axes decide about the computation is kept exactly:
``attn_strategy`` picks ``_sdpa``'s branch and ``moe_groups`` the MoE
dispatch groups (and so the per-group capacity).  Parameter specs are
plain tuples of axis names (``None`` for a replicated dimension), equal to
``tuple(PartitionSpec(...))`` of the reference's rules: FSDP (the
d_model-ish dim over "data") x TP (heads / ffn / experts / vocab over
"model").
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

_ACTIVE: dict = {"batch_axes": None, "model_axis": None, "sizes": {}}


@contextlib.contextmanager
def axis_env(batch_axes, model_axis, sizes: Optional[dict] = None):
    """Activate activation-constraint axes (e.g. (("pod","data"),"model")).

    ``sizes``: mesh axis name -> size, for divisibility-aware choices.
    """
    old = dict(_ACTIVE)
    _ACTIVE["batch_axes"] = batch_axes
    _ACTIVE["model_axis"] = model_axis
    _ACTIVE["sizes"] = sizes or {}
    try:
        yield
    finally:
        _ACTIVE.update(old)


def _msize() -> int:
    m = _ACTIVE["model_axis"]
    return _ACTIVE["sizes"].get(m, 0) or 1


def _bsize() -> int:
    b = _ACTIVE["batch_axes"]
    n = 1
    for a in (b if isinstance(b, tuple) else (b,)):
        n *= _ACTIVE["sizes"].get(a, 1)
    return n


def constrain(x, kind: str):
    """Annotate an activation (kind in {btd, btf, bthd, ecd, gecd,
    gecd_back, logits}): the identity on one card."""
    return x


def attn_strategy(n_heads: int, n_kv_heads: int) -> str:
    """How the reference shards attention internals over the TP axis.

    "kv"      kv-head count divides TP: shard the kv axis.
    "repeat"  total heads divide TP but kv does not: ``_sdpa`` repeats K/V
              to H heads (a different computation, the same result).
    "seq"     neither divides: sequence-parallel attention internals.
    """
    if _ACTIVE["batch_axes"] is None:
        return "kv"
    ms = _msize()
    if n_kv_heads % ms == 0:
        return "kv"
    if n_heads % ms == 0:
        return "repeat"
    return "seq"


def moe_groups(n_tokens: int) -> int:
    """MoE dispatch groups = data shards (1 when no axes are active)."""
    if _ACTIVE["batch_axes"] is None:
        return 1
    g = _bsize()
    return g if n_tokens % g == 0 else 1


def constrain_heads(x, head_axis: int, seq_axis: Optional[int] = None):
    """Shard an attention tensor over heads, else sequence: the identity on
    one card."""
    return x


# ---------------------------------------------------------------------------
# Parameter partition specs (path pattern -> spec tuple)
# ---------------------------------------------------------------------------

_RULES = [
    # pattern on the param path (joined with /), spec builder given ndim.
    # Stacked layer params have a leading L dim (never sharded).
    (r"embed", lambda nd, d, m: (m, None)),
    (r"pos_embed", lambda nd, d, m: (None, None)),
    (r"lm_head", lambda nd, d, m: (None, m)),
    (r"(wq|wk|wv|wq_b|wk_b|wv_b|wq_a|wkv_a)$",
     lambda nd, d, m: _lastdims(nd, d, m)),
    (r"wo$", lambda nd, d, m: _lastdims(nd, m, d)),
    (r"(w_gate|w_up)$", lambda nd, d, m: _lastdims(nd, d, m)),
    (r"w_down$", lambda nd, d, m: _lastdims(nd, m, d)),
    (r"router$", lambda nd, d, m: _lastdims(nd, d, None)),
    (r"(we_gate|we_up)$", lambda nd, d, m: _expert(nd, d, m)),
    (r"we_down$", lambda nd, d, m: _expert_down(nd, d, m)),
    (r"(in_proj|x_proj)$", lambda nd, d, m: _lastdims(nd, d, m)),
    (r"out_proj$", lambda nd, d, m: _lastdims(nd, m, d)),
    (r"dt_proj$", lambda nd, d, m: _lastdims(nd, None, m)),
    (r"(A_log|conv_w)$", lambda nd, d, m: _lastdims(nd, None, m)),
]


def _lastdims(nd, a, b) -> tuple:
    """The last two dims as (a, b), leading dims replicated."""
    return (None,) * (nd - 2) + (a, b)


def _expert(nd, d, m) -> tuple:
    """(..., E, din, dout) expert weights: E over the data axes, the last
    dim over the model axis."""
    return (None,) * (nd - 3) + (d, None, m)


def _expert_down(nd, d, m) -> tuple:
    """(..., E, ff, d_model): E over data, the contraction dim ff over
    model."""
    return (None,) * (nd - 3) + (d, m, None)


def param_partition_spec(path: str, ndim: int, data_axes="data",
                         model_axis="model") -> tuple:
    """The spec of the parameter at ``path`` (keys joined with ``/``) with
    ``ndim`` dims: the first matching rule's, trimmed or padded with
    ``None`` on the left to ``ndim``; replicated when no rule matches."""
    for pat, fn in _RULES:
        if re.search(pat, path):
            parts = list(fn(ndim, data_axes, model_axis))
            if len(parts) > ndim:
                parts = parts[len(parts) - ndim:]
            while len(parts) < ndim:
                parts.insert(0, None)
            return tuple(parts)
    return (None,) * ndim       # biases, norms, scalars: replicated


def tree_partition_specs(params, data_axes="data", model_axis="model"):
    """A nested dict of spec tuples matching a nested dict of tensors."""
    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else param_partition_spec(f"{prefix}{k}", v.ndim, data_axes,
                                          model_axis)
                for k, v in tree.items()}
    return walk(params, "")
