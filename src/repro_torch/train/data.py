"""Synthetic, deterministic, restartable token pipeline (the port's own
copy of ``repro.train.data``).

Production shape: each host owns a disjoint shard of the global batch
(``host_id``/``num_hosts``); batches are a pure function of (seed, step), so
a restart at step k regenerates bit-identical data without replaying the
stream.  numpy only: ``batch_at`` is bitwise the reference's for every
``(seed, step, host_id, num_hosts)``; callers make tensors from its int32
(and f32 ``enc_feats``) arrays on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    enc_frames: int = 0          # >0 for enc-dec archs (stub frontend)
    d_model: int = 0


class SyntheticTokens:
    """Markov-ish synthetic LM data (not uniform noise, so loss can fall)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        B, S = self.local_batch, cfg.seq_len
        # structured stream: tokens follow a noisy linear-congruential walk,
        # giving the model a learnable next-token signal
        base = rng.integers(0, cfg.vocab_size, (B, 1))
        steps = rng.integers(1, 7, (B, S))
        toks = (base + np.cumsum(steps, axis=1)) % cfg.vocab_size
        noise = rng.random((B, S)) < 0.05
        toks = np.where(noise,
                        rng.integers(0, cfg.vocab_size, (B, S)), toks)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if cfg.enc_frames:
            out["enc_feats"] = rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
