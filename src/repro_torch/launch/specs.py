"""Input stand-ins + shardings for every (arch x shape x mesh) cell (torch
twin of ``repro.launch.specs``).

``abstract_params`` builds the parameter tree under ``FakeTensorMode``:
fake tensors carry the shape and dtype of every leaf (the reference's
``ShapeDtypeStruct``s) and allocate nothing.  A sharding is the sanitized
spec tuple of ``repro_torch.models.sharding`` (``tuple(PartitionSpec)``
of the reference's ``NamedSharding``): FSDP x TP for parameters
(divisibility-sanitized per mesh), batch over the data axes, decode caches
sequence- or head-sharded over "model".  ``shard_bytes`` is what one
device of the mesh holds of a leaf.

Dtypes are the reference's, leaf for leaf: params and moments f32,
``step`` int32, tokens and labels int32, ``enc_feats`` f32, the decode
cache (its SSM state f32) and ``enc_out`` bf16.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.sharding import tree_partition_specs
from repro_torch.train.optimizer import init_opt_state


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _fake_mode(tree) -> FakeTensorMode:
    """The fake mode the leaves of ``tree`` were made in."""
    return T.tree_leaves(tree)[0].fake_mode


@functools.lru_cache(maxsize=None)
def _fake_params(cfg: ModelConfig):
    with FakeTensorMode():
        return T.init_lm(cfg, 0, "cpu")


def abstract_params(cfg: ModelConfig):
    """The parameter tree as fake tensors (never materialized).  Built once
    a config; each call returns a tree of its own over the same leaves."""
    return T.tree_map(lambda a: a, _fake_params(cfg))


def abstract_opt_state(params):
    with _fake_mode(params):
        return init_opt_state(params)


def sanitize_spec(spec: tuple, shape: Tuple[int, ...], mesh) -> tuple:
    """Drop mesh axes that do not divide the corresponding dim.  A
    one-axis tuple is written as its axis, as ``PartitionSpec`` does."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None or dim % axis_size(mesh, part) != 0:
            out.append(None)
        elif isinstance(part, tuple) and len(part) == 1:
            out.append(part[0])
        else:
            out.append(part)
    return tuple(out)


def tree_shardings(tree, specs, mesh):
    return _map2(lambda leaf, spec: sanitize_spec(spec, leaf.shape, mesh),
                 tree, specs)


def param_shardings(cfg: ModelConfig, mesh):
    params = abstract_params(cfg)
    specs = tree_partition_specs(params, data_axes=data_axes(mesh),
                                 model_axis="model")
    return params, tree_shardings(params, specs, mesh)


def _stand_in(shape, dtype) -> torch.Tensor:
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype)


def _batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    da = data_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _stand_in((B, S), torch.int32),
             "labels": _stand_in((B, S), torch.int32)}
    specs = {"tokens": (da, None), "labels": (da, None)}
    if cfg.encdec is not None:
        e = cfg.encdec
        batch["enc_feats"] = _stand_in((B, e.encoder_frames, cfg.d_model),
                                       torch.float32)
        specs["enc_feats"] = (da, None, None)
    return batch, specs


def _cache_spec_tree(cfg: ModelConfig, cache, mesh):
    """Decode-cache specs: batch over data, long dims over model.

    K/V caches shard over *kv heads* when the TP degree divides them, else
    over sequence — the reference's in-kernel attention strategy.
    """
    ms = axis_size(mesh, "model")

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in ("k", "v"):        # (L, B, S, Hkv, hd)
                out[name] = ((None, "data", None, "model", None)
                             if cfg.n_kv_heads % ms == 0
                             else (None, "data", "model", None, None))
            elif name in ("c_kv", "k_rope"):    # (L, B, S, r)
                out[name] = (None, "data", "model", None)
            elif name == "conv":            # (L, B, K, Din)
                out[name] = (None, "data", None, "model")
            elif name == "ssm":             # (L, B, Din, N)
                out[name] = (None, "data", "model", None)
            else:
                out[name] = (None,) * leaf.ndim
        return out

    return walk(cache)


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int):
    """The stacked decode cache (``init_full_cache`` at bf16) as fake
    tensors."""
    with FakeTensorMode():
        return T.init_full_cache(cfg, batch, seq_len, torch.bfloat16,
                                 device="cpu")


@dataclasses.dataclass
class CellSpec:
    """Everything needed to trace one (arch x shape x mesh) cell."""
    kind: str                  # train|prefill|decode
    args: tuple                # fake-tensor trees
    in_shardings: tuple        # sanitized spec tuples, tree for tree
    out_shardings: Any


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> CellSpec:
    da = data_axes(mesh)
    params, p_shard = param_shardings(cfg, mesh)
    if shape.kind == "train":
        opt = abstract_opt_state(params)
        # optimizer moments shard exactly like their parameters (ZeRO)
        o_shard = {"mu": p_shard, "nu": p_shard, "step": ()}
        batch, b_specs = _batch_specs(cfg, shape, mesh)
        b_shard = _map2(lambda leaf, s: sanitize_spec(s, leaf.shape, mesh),
                        batch, b_specs)
        return CellSpec(
            kind="train",
            args=(params, opt, batch),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, {"loss": (), "grad_norm": ()}))
    if shape.kind == "prefill":
        batch, b_specs = _batch_specs(cfg, shape, mesh)
        logits_shard = sanitize_spec(
            (da, None, "model"),
            (shape.global_batch, shape.seq_len, cfg.vocab_size), mesh)
        args = [params, batch["tokens"]]
        shards = [p_shard, b_shard_one(batch["tokens"], b_specs["tokens"],
                                       mesh)]
        if cfg.encdec is not None:
            args.append(batch["enc_feats"])
            shards.append(b_shard_one(batch["enc_feats"],
                                      b_specs["enc_feats"], mesh))
        return CellSpec(kind="prefill", args=tuple(args),
                        in_shardings=tuple(shards),
                        out_shardings=logits_shard)
    # decode: one new token against a seq_len cache
    B, S = shape.global_batch, shape.seq_len
    cache = abstract_cache(cfg, B, S)
    c_shard = tree_shardings(cache, _cache_spec_tree(cfg, cache, mesh), mesh)
    token = _stand_in((B, 1), torch.int32)
    tok_shard = sanitize_spec((da, None), (B, 1), mesh)
    pos = _stand_in((), torch.int32)
    args = [params, cache, token, pos]
    shards = [p_shard, c_shard, tok_shard, ()]
    if cfg.encdec is not None:
        enc_out = _stand_in((B, cfg.encdec.encoder_frames, cfg.d_model),
                            torch.bfloat16)
        args.append(enc_out)
        shards.append(sanitize_spec((da, None, None), enc_out.shape, mesh))
    logits_shard = sanitize_spec((da, None, "model"),
                                 (B, 1, cfg.vocab_size), mesh)
    return CellSpec(kind="decode", args=tuple(args),
                    in_shardings=tuple(shards),
                    out_shardings=(logits_shard, c_shard))


def b_shard_one(leaf, spec, mesh) -> tuple:
    return sanitize_spec(spec, leaf.shape, mesh)


def shard_bytes(leaf, spec, mesh) -> int:
    """Bytes of ``leaf`` one device holds: its bytes over the sizes of the
    mesh axes its sanitized ``spec`` keeps."""
    n = leaf.numel() * leaf.element_size()
    for part in sanitize_spec(spec, leaf.shape, mesh):
        if part is not None:
            n //= axis_size(mesh, part)
    return n


def tree_shard_bytes(tree, specs, mesh) -> int:
    """``shard_bytes`` summed over a tree of leaves (a tensor, dict, list
    or tuple) and its matching specs."""
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(v, specs[k], mesh)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(tree_shard_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return shard_bytes(tree, specs, mesh)
