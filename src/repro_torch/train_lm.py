"""End-to-end example: train a ~100M-parameter qwen2-family model (torch
twin of ``examples/train_lm.py``).

Exercises the full training substrate: synthetic data pipeline, AdamW,
per-layer remat, checkpointing every 100 steps and at the end, resume
from the newest valid checkpoint, and loss reporting.  The example's
model (qwen2 scaled to 8 layers, d_model 768, 12/4 heads, d_ff 3072,
vocab 32,000, tied), optimizer (lr 3e-4, 50 warmup steps), bf16 compute,
flags and printed lines.  Params are ``init_lm`` from seed 0 drawn on the
CPU and copied (torch's CPU and CUDA generators differ), so every device
starts from the same weights.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--steps 300]
      [--batch 8] [--seq 256] [--ckpt-dir DIR] [--device cpu]

The device defaults to ``cuda``, which raises without a card; the
checkpoint directory to ``repro_torch_train_lm`` under the temporary
directory.  The last line is one JSON object: the losses of the steps run,
the wall seconds of the loop and of its first step, the tok/s over the
loop (as the example counts them) and over the steps after the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticTokens
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import make_train_step

OPT = AdamWConfig(lr=3e-4, warmup_steps=50)
SAVE_EVERY = 100


def model_config() -> ModelConfig:
    """~100M params: qwen2 family, scaled."""
    return dataclasses.replace(
        get_config("qwen2-0.5b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32000,
        tie_embeddings=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_lm",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config()
    params = T.tree_map(lambda a: a.to(dev), T.init_lm(cfg, 0, "cpu"))
    n_params = T.count_params(params)
    print(f"model: {cfg.name}-derived, {n_params/1e6:.1f}M params")

    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, OPT, cdt=torch.bfloat16, device=dev)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      global_batch=args.batch,
                                      seq_len=args.seq + 1))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    state = {"params": params, "opt": opt_state}
    start = 0
    restored = ckpt.restore_latest(state)
    if restored:
        start, state, _ = restored
        print(f"resumed from step {start}")

    losses, first_s = [], 0.0
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        p, o, m = step_fn(state["params"], state["opt"],
                          data.batch_at(step))
        state = {"params": p, "opt": o}
        losses.append(m["loss"])
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / dt
            first_s = first_s or dt          # the first step, warm-up in
            print(f"step {step:4d} | loss {float(m['loss']):7.4f} | "
                  f"gnorm {float(m['grad_norm']):6.2f} | {tok_s:,.0f} tok/s")
        if (step + 1) % SAVE_EVERY == 0:
            ckpt.save(step + 1, state)
    sync(dev)
    seconds = time.perf_counter() - t0
    ckpt.save(args.steps, state)
    print("done.")
    n_run, tokens = max(args.steps - start, 0), args.batch * args.seq
    return dict(device=str(dev), model=f"{cfg.name}-derived",
                params=n_params, start=start, steps=args.steps,
                losses=torch.stack(losses).tolist() if losses else [],
                seconds=seconds, first_step_s=first_s,
                tok_per_s=n_run * tokens / seconds if n_run else 0.0,
                tok_per_s_after_first=(n_run - 1) * tokens
                / (seconds - first_s) if n_run > 1 else 0.0)


def cli(argv=None) -> int:
    print(json.dumps(main(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
