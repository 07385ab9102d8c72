"""Serving: batched prefill + decode with a KV cache (torch twin of
``examples/serve_lm.py``).

Builds a reduced falcon-mamba (constant-memory state) and a reduced qwen2
(KV cache) model, feeds a batch of prompts through the serve step token by
token and generates greedy continuations.  As the example: random weights
(``init_lm`` from seed 0, drawn on the CPU whatever the device), fp32
compute, prompts drawn on the host from
``np.random.default_rng(0)`` (so they are the reference's bitwise).

Run:  PYTHONPATH=src python -m repro_torch.serve_lm [--device cpu]

The device defaults to ``cuda``, which raises without a card.  The last
line is one JSON object: per model the generated tokens and the tok/s.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.steps import make_serve_step

B, PROMPT, GEN = 4, 32, 32
ARCHS = ("qwen2-0.5b",          # KV-cache attention path
         "falcon-mamba-7b")     # constant-state SSM path


def serve(cfg: ModelConfig, params=None, device="cuda", cdt=torch.float32,
          batch: int = B, prompt: int = PROMPT, gen: int = GEN) -> dict:
    """Prefill ``prompt`` tokens token by token through the serve step,
    then ``gen`` greedy tokens (the first from the prompt's last logits).
    ``params`` default to ``init_lm(cfg, 0)`` drawn on the CPU.  Returns
    the tokens (numpy ``(batch, gen)``), the wall seconds (after a sync)
    and tok/s over ``batch * (prompt + gen)`` tokens, as the example counts
    them."""
    dev = resolve_device(device)
    if params is None:
        # drawn on the CPU and copied: the same params (and tokens) on
        # every device, as the reference's jax.random.key(0)
        params = T.tree_map(lambda a: a.to(dev), T.init_lm(cfg, 0, "cpu"))
    serve_step = make_serve_step(cfg, cdt=cdt)
    cache = T.init_full_cache(cfg, batch, prompt + gen, cdt=cdt, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt)), device=dev)
    positions = torch.arange(prompt + gen, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for pos in range(prompt):
        logits, cache = serve_step(params, cache, prompts[:, pos:pos + 1],
                                   positions[pos])
    toks = [torch.argmax(logits, dim=-1)]
    for pos in range(prompt, prompt + gen - 1):
        logits, cache = serve_step(params, cache, toks[-1], positions[pos])
        toks.append(torch.argmax(logits, dim=-1))
    out = torch.cat(toks, dim=1).cpu().numpy()     # waits for the device
    dt = time.perf_counter() - t0
    return dict(tokens=out, seconds=dt,
                tok_per_s=batch * (prompt + gen) / dt)


def main(device="cuda") -> dict:
    """Serve the example's two models at ``.reduced()``."""
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        res = serve(get_config(arch).reduced(), device=dev)
        print(f"{arch}: generated {B}x{GEN} tokens in {res['seconds']:.2f}s "
              f"({res['tok_per_s']:,.0f} tok/s incl. prefill)")
        print(f"  sample continuation: {res['tokens'][0][:12].tolist()}")
        out[arch] = dict(tokens=res["tokens"].tolist(),
                         seconds=res["seconds"], tok_per_s=res["tok_per_s"])
    return dict(device=str(dev), batch=B, prompt=PROMPT, gen=GEN,
                models=out)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_lm",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
