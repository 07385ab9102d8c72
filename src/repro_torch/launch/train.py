"""Production training launcher (``python -m repro_torch.launch.train``;
torch twin of ``repro.launch.train``).

Composes the training stack on one device: host-sharded synthetic data,
the train step (fp32 compute), checkpoint/restart, and the straggler
monitor.  The reference's flags and printed lines, plus ``--device``
(default ``cuda``, which raises without a card).  Configs are the
``reduced()`` ones, as the reference's (its ``--reduced`` defaults to on
and has no off switch).  Params are ``init_lm`` from seed 0 drawn on the
CPU and copied, so every device starts from the same weights.  The last
line is one JSON object: the loss and wall ms of every step run.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticTokens
from repro_torch.train.fault import StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the reference's default)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = T.tree_map(lambda a: a.to(dev), T.init_lm(cfg, 0, "cpu"))
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[launch] {args.arch}: {T.count_params(params)/1e6:.1f}M params "
          f"(reduced={args.reduced}), devices={n_dev}")
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3), cdt=torch.float32,
                              device=dev)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq + 1,
        enc_frames=cfg.encdec.encoder_frames if cfg.encdec else 0,
        d_model=cfg.d_model))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir \
        else None
    monitor = StragglerMonitor(n_hosts=1)

    state = {"params": params, "opt": opt_state}
    start = 0
    if ckpt:
        restored = ckpt.restore_latest(state)
        if restored:
            start, state, _ = restored
            print(f"[launch] resumed from step {start}")
    losses, ms = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        p, o, m = step_fn(state["params"], state["opt"],
                          data.batch_at(step))
        state = {"params": p, "opt": o}
        dur = time.perf_counter() - t0
        flagged = monitor.observe([dur])
        if flagged:
            monitor.mitigate(flagged, 1)
        loss = float(m["loss"])
        print(f"[launch] step {step} loss={loss:.4f} ({dur*1e3:.0f} ms)")
        losses.append(loss)
        ms.append(dur * 1e3)
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(args.steps, state)
    print("[launch] done")
    return dict(device=str(dev), arch=args.arch, devices=n_dev, start=start,
                losses=losses, step_ms=ms,
                reassignments=monitor.reassignments)


def cli(argv=None) -> int:
    print(json.dumps(main(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
