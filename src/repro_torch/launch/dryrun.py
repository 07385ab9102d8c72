"""Dry run of every (arch x shape x mesh) cell (torch twin of
``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 and 512 placeholder
TPU devices and reads XLA's memory and cost analyses.  One card has no
twin of that lowering, so each cell is traced here instead: the port's
own step (``make_train_step`` / ``make_prefill`` / ``make_serve_step``)
runs on the meta device (shapes without data: nothing is allocated) at
the global shape, under the mesh's axis environment
(``models.sharding.axis_env``, as the reference's), with one dispatch
mode (``_Trace``) counting as it goes.  A record for the ``single`` and
``multi`` meshes holds:

- ``memory``: per-device argument, output and alias (the donated decode
  cache) bytes, exact from ``specs`` (``shard_bytes``); ``peak_bytes`` is
  argument + output - alias, a lower bound (``peak_is_lower_bound``):
  there is no partitioned program, so ``temp_bytes`` is ``None``;
- ``cost``: the step's FLOPs by ``FlopCounterMode``'s formulas (matmul,
  convolution and attention only) and its bytes (``op_bytes``: every
  aten op's operands and results, no fusion), each over the device
  count.  The trace runs every layer, where XLA counts a while body once;
  a cell whose whole trace would dispatch more than ``TRACE_OPS_LIMIT``
  aten ops is traced at depths 1 and 2 and extrapolated to its depth
  (``extrapolated_from_depths``);
- ``collectives``: ``None`` (an unpartitioned torch step has none).

The ``card`` mesh, ("data", "model") = (1, 1), is what the card itself
runs: the trace also follows the live bytes of every storage the step
makes (``peak_estimate_bytes``, the arguments included).  Where that fits
within ``CARD_FRACTION`` of the card's memory the step runs for real
(decode at ``pos = seq_len - 1``, so the whole cache is read) and the
record holds its median ms and measured peak beside the estimate; else it
is a SKIP, "exceeds one card".  A cell the estimate let through that then
fails is a FAIL.

Results are merged into ``launch_artifacts/dryrun_results_torch.json``
(never the reference's ``dryrun_results.json``) row by row under a lock,
so interrupted sweeps resume and several dry runs may share the file.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # full sweep
  ... dryrun --arch qwen2-0.5b --shape decode_32k --mesh card
  ... dryrun --arch qwen2-0.5b --probe    # depth-1/2 probes
  ... dryrun --amg                        # distributed-AMG rows
  ... --device cpu      # single/multi rows only, no card
"""
from __future__ import annotations

import argparse
import fcntl
import gc
import json
import os
import re
import statistics
import subprocess
import time
import traceback
import weakref
from functools import partial

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.backend import resolve_device, sync
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import data_axes, make_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import LM_SHAPES, cell_applicable, \
    shape_by_name
from repro_torch.models.sharding import attn_strategy, axis_env, \
    moe_groups
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import make_prefill, make_serve_step, \
    make_train_step

RESULTS_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "launch_artifacts", "dryrun_results_torch.json")

#: a card row runs when its estimated peak is within this share of the
#: card's memory
CARD_FRACTION = 0.9
#: timed calls of a card row (after one warm-up call)
CARD_REPS = 5
#: a cell whose whole trace would dispatch more aten ops than this is
#: traced at depths 1 and 2 and extrapolated (``trace_cell``):
#: falcon-mamba-7b's train_4k and prefill_32k dispatch 1.5 and 2.8 million
#: at 64 layers, minutes of host time each traced whole
TRACE_OPS_LIMIT = 250_000

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16}
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\]\S*))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def collective_census(hlo_text: str) -> dict:
    """Sum result bytes of every collective op, by op kind (per device).

    A pure text function over HLO, so the port reads what the reference
    compiled."""
    out = {k: {"bytes": 0, "count": 0}
           for k in ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")}
    for m in _COLL_RE.finditer(hlo_text):
        shapes_blob, kind = m.group(1), m.group(2)
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(shapes_blob):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        if "-done" in hlo_text[m.start():m.end()]:
            continue  # async pairs: counted at -start
        out[kind]["bytes"] += nbytes
        out[kind]["count"] += 1
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out


def _load_results() -> dict:
    if os.path.exists(RESULTS_PATH):
        with open(RESULTS_PATH) as f:
            return json.load(f)
    return {}


def _save_results(res: dict) -> None:
    """Merge the rows of ``res`` into the results file, under a lock:
    several dry runs may write it at once."""
    os.makedirs(os.path.dirname(RESULTS_PATH), exist_ok=True)
    with open(RESULTS_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        merged = _load_results()
        merged.update(res)
        tmp = RESULTS_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, RESULTS_PATH)


def _probe_config(cfg, depth: int):
    """Same model at depth ``depth`` (for loop-cost decomposition).

    The reference needs the probes because XLA's cost analysis counts a
    while-loop body once; the port's trace runs every layer, so
    ``roofline._loop_corrected`` over its probes must give back the full
    trace's count (``chip_smoke.py`` checks it).
    """
    import dataclasses
    per_unit = 2 if (cfg.moe and cfg.moe.moe_every == 2) else 1
    kw = {"n_layers": depth * per_unit}
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec,
                                           n_encoder_layers=depth)
    return dataclasses.replace(cfg, **kw)


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``None`` where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the trace: FLOPs, bytes accessed and live bytes of a step, allocating
# nothing
# ---------------------------------------------------------------------------

#: aten ops that only allocate: no byte of theirs is read or written
_ALLOC_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}
#: gathers read only the rows they return: the indices, the output's bytes
#: read and the output written
_GATHERS = {"index", "index_select", "gather", "embedding"}
#: in-place scatters write only as many bytes of their destination as
#: their source holds: the indices or mask, the source read and written
_SCATTERS = {"index_copy_", "index_put_", "_index_put_impl_", "scatter_",
             "scatter_add_", "scatter_reduce_", "index_add_",
             "masked_scatter_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_id(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op reads and writes, without fusion: every tensor
    operand read once and every result written once; a view (all its
    results alias an operand, nothing mutated) moves none, an allocation
    none; a gather, an in-place scatter and ``copy_`` move only what they
    touch (``_GATHERS``, ``_SCATTERS``)."""
    name = func.overloadpacket.__name__
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if name in _ALLOC_ONLY:
        return 0
    if name in _GATHERS:
        return sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
    if name in _SCATTERS:
        return sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
    if name == "copy_":
        return _nbytes(ins[0]) + _nbytes(ins[1])
    if not func._schema.is_mutable:
        held = {_storage_id(t) for t in ins}
        if outs and all(_storage_id(t) in held for t in outs):
            return 0
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


class _Trace(TorchDispatchMode):
    """One pass over a step's aten ops: FLOPs by ``FlopCounterMode``'s
    formulas (``flop_registry``; an op without one is decomposed first
    where it can be, as ``FlopCounterMode`` does), ``op_bytes``, and the
    bytes of the storages alive with their peak (a storage counts once,
    from the op that makes it until it is freed).  One mode, not three
    stacked: each stacked mode re-dispatches every op below it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace != "aten":
            return func(*args, **kwargs)
        packet = func.overloadpacket
        if packet not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        self.ops += 1
        self.bytes += op_bytes(func, args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    n = st.nbytes()
                    self._seen[st] = weakref.ref(st, partial(self._free, n))
                    self.live += n
                    self.peak = max(self.peak, self.live)
        return out


def _step(cfg, kind: str, device):
    if kind == "train":
        return make_train_step(cfg, AdamWConfig(), device=device)
    if kind == "prefill":
        return make_prefill(cfg)
    return make_serve_step(cfg)


def _env_key(cfg, shape, mesh) -> tuple:
    """What the mesh's axis environment decides about the step: whether
    attention repeats K/V to every head (``_sdpa``'s one branch on it) and
    the MoE dispatch groups.  Cells that agree on it trace the same
    program."""
    with axis_env(data_axes(mesh), "model", mesh.shape):
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        repeat = (cfg.attention != "none" and attn_strategy(
            cfg.n_heads, cfg.n_kv_heads) == "repeat")
        return (repeat, moe_groups(tokens) if cfg.moe else None)


def _trace_once(cfg, shape, mesh, cell=None) -> dict:
    """Trace one cell's step on the meta device (shapes, no data) at the
    global shape: its FLOPs, bytes accessed, aten ops, the peak of live
    bytes (arguments included), the output trees and their per-device
    bytes."""
    cell = cell or S.build_cell(cfg, shape, mesh)
    meta = torch.device("meta")
    t0 = time.perf_counter()
    tr = _Trace()
    with axis_env(data_axes(mesh), "model", mesh.shape), tr:
        args = tuple(T.tree_map(lambda a: torch.empty(
            a.shape, dtype=a.dtype, device=meta), t)
            if isinstance(t, dict) else torch.empty(t.shape, dtype=t.dtype,
                                                    device=meta)
            for t in cell.args)
        out = _step(cfg, cell.kind, meta)(*args)
    return dict(flops=float(tr.flops), bytes=float(tr.bytes), ops=tr.ops,
                peak_live_bytes=tr.peak, out=out,
                output_bytes=S.tree_shard_bytes(out, cell.out_shardings,
                                                mesh),
                trace_s=time.perf_counter() - t0)


def _units(cfg) -> int:
    """The units ``_probe_config`` repeats: a layer, or a dense and an MoE
    layer where MoE comes every other layer."""
    per = 2 if (cfg.moe and cfg.moe.moe_every == 2) else 1
    return cfg.n_layers // per


def trace_cell(cfg, shape, mesh, cell=None) -> dict:
    """``_trace_once`` of the whole step; or, where that would dispatch
    more than ``TRACE_OPS_LIMIT`` aten ops (the depth-1 probe's ops times
    the units), the depth-1 and depth-2 probes' counts extrapolated to the
    config's units (``depths``; no ``out``): outside + units * body, exact
    where every unit is the same program."""
    units = _units(cfg)
    if units > 2 and (cfg.encdec is None
                      or cfg.encdec.n_encoder_layers == units):
        d1 = _trace_once(_probe_config(cfg, 1), shape, mesh)
        if d1["ops"] * units > TRACE_OPS_LIMIT:
            d2 = _trace_once(_probe_config(cfg, 2), shape, mesh)
            rec = {k: d1[k] + (units - 1) * (d2[k] - d1[k])
                   for k in ("flops", "bytes", "ops", "peak_live_bytes",
                             "output_bytes")}
            return dict(rec, out=None, depths=[1, 2],
                        trace_s=d1["trace_s"] + d2["trace_s"])
    return _trace_once(cfg, shape, mesh, cell)


def _memory(cell, outb: int, mesh) -> dict:
    arg = S.tree_shard_bytes(cell.args, cell.in_shardings, mesh)
    alias = (S.tree_shard_bytes(cell.args[1], cell.in_shardings[1], mesh)
             if cell.kind == "decode" else 0)
    return {"argument_bytes": arg, "output_bytes": outb,
            "alias_bytes": alias, "temp_bytes": None,
            "peak_bytes": arg + outb - alias, "peak_is_lower_bound": True}


def _real_args(cfg, shape, kind: str, dev) -> tuple:
    """The step's arguments on ``dev``: ``init_lm`` params drawn there,
    random tokens, a zero cache, ``pos = seq_len - 1``."""
    B, Sq = shape.global_batch, shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_lm(cfg, 0, dev)

    def toks(s):
        return torch.randint(0, cfg.vocab_size, (B, s), generator=gen,
                             device=dev, dtype=torch.int32)

    def feats(dtype):
        return torch.randn((B, cfg.encdec.encoder_frames, cfg.d_model),
                           generator=gen, device=dev).to(dtype)

    if kind == "train":
        batch = {"tokens": toks(Sq), "labels": toks(Sq)}
        if cfg.encdec is not None:
            batch["enc_feats"] = feats(torch.float32)
        return (params, init_opt_state(params), batch)
    if kind == "prefill":
        return (params, toks(Sq)) + ((feats(torch.float32),)
                                     if cfg.encdec is not None else ())
    cache = T.init_full_cache(cfg, B, Sq, torch.bfloat16, device=dev)
    pos = torch.tensor(Sq - 1, dtype=torch.int32, device=dev)
    return (params, cache, toks(1), pos) + (
        (feats(torch.bfloat16),) if cfg.encdec is not None else ())


def run_on_card(cfg, shape, kind: str, dev) -> dict:
    """Run the cell's step for real on ``dev``: one warm-up call, then
    ``CARD_REPS`` timed calls (a train step feeds its new state to the
    next); the median ms and, on a card, the peak allocated above what was
    held before."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    args = _real_args(cfg, shape, kind, dev)
    fn = _step(cfg, kind, dev)
    ms, finite = [], True
    for i in range(CARD_REPS + 1):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(dev)
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        if kind == "train":
            args = (out[0], out[1], args[2])
            head = out[2]["loss"]
        else:
            head = out[0] if kind == "decode" else out
        finite = finite and bool(torch.isfinite(head.float()).all())
        del out, head
    peak = (torch.cuda.max_memory_allocated(dev) - held
            if dev.type == "cuda" else None)
    del args
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not finite:
        raise FloatingPointError(f"{cfg.name} {shape.name}: a call's "
                                 f"output is not finite")
    return {"ms": statistics.median(ms), "ms_all": ms,
            "peak_measured_bytes": peak}


def cell_record(cfg, shape, mesh_name: str, *, device=None, traces=None,
                capacity_bytes=None) -> dict:
    """One cell's record (see the module docstring).  ``traces`` caches
    traces across cells that trace the same program; a ``card`` cell runs
    on ``device`` against ``capacity_bytes`` (default: the card's
    memory)."""
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": why}
    if mesh_name == "card":
        if device is None:
            raise ValueError("a card cell runs on a device: pass device=")
        dev = resolve_device(device)
    mesh = make_mesh(mesh_name)
    cell = S.build_cell(cfg, shape, mesh)
    key = (cfg, shape.name) + _env_key(cfg, shape, mesh)
    tr = traces.get(key) if traces is not None else None
    if tr is None:
        tr = trace_cell(cfg, shape, mesh, cell)
        if traces is not None:
            traces[key] = tr
    nd = mesh.size
    rec = {"status": "OK", "kind": cell.kind,
           "mesh": list(mesh.axis_sizes), "n_devices": nd,
           "trace_s": round(tr["trace_s"], 2), "aten_ops": tr["ops"],
           "memory": _memory(cell, tr["output_bytes"], mesh),
           "cost": {"flops_per_device": tr["flops"] / nd,
                    "bytes_accessed_per_device": tr["bytes"] / nd,
                    "bytes_traced_per_op": True},
           "collectives": None}
    if "depths" in tr:
        rec["extrapolated_from_depths"] = tr["depths"]
    if mesh_name != "card":
        return rec
    if capacity_bytes is None:
        capacity_bytes = torch.cuda.get_device_properties(dev).total_memory
    est = tr["peak_live_bytes"]
    if "depths" in tr and est <= CARD_FRACTION * capacity_bytes:
        # an extrapolated peak can fall short (a unit's live set grows
        # with depth under the checkpoints): a cell it lets through is
        # traced whole before it runs
        est = _trace_once(cfg, shape, mesh, cell)["peak_live_bytes"]
    rec["memory"].update(peak_estimate_bytes=est,
                         capacity_bytes=capacity_bytes)
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    rec["card"] = card_line() if dev.type == "cuda" else None
    if est > CARD_FRACTION * capacity_bytes:
        return dict(rec, status="SKIP", reason="exceeds one card")
    run = run_on_card(cfg, shape, cell.kind, dev)
    rec["memory"].update(peak_measured_bytes=run["peak_measured_bytes"],
                         peak_is_lower_bound=False)
    if run["peak_measured_bytes"] is not None:
        rec["memory"]["peak_bytes"] = run["peak_measured_bytes"]
    rec["measured"] = {"ms": run["ms"], "ms_all": run["ms_all"]}
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str,
             variant: str = "base", depth_override: int | None = None, *,
             device=None, traces=None) -> dict:
    """One cell of the registry's ``arch`` (at probe depth
    ``depth_override``); returns the recorded analysis dict."""
    del variant     # recorded in the key by the caller
    cfg = get_config(arch)
    if depth_override is not None:
        cfg = _probe_config(cfg, depth_override)
    return cell_record(cfg, shape_by_name(shape_name), mesh_name,
                       device=device, traces=traces)


def _summary_line(rec: dict) -> str:
    if rec["status"] != "OK":
        est = rec.get("memory", {}).get("peak_estimate_bytes")
        extra = f" (estimate {est / 1e9:.2f} GB)" if est else ""
        return (f"         {rec['status']}: "
                f"{rec.get('reason', rec.get('error'))}{extra}")
    m = rec["memory"]
    line = (f"         OK kind={rec['kind']} trace={rec['trace_s']}s "
            f"ops={rec['aten_ops']} "
            f"flops/dev={rec['cost']['flops_per_device']:.4g} "
            f"args/dev={m['argument_bytes'] / 2**20:.0f}MiB "
            f"peak/dev{'>=' if m['peak_is_lower_bound'] else '='}"
            f"{m['peak_bytes'] / 2**20:.0f}MiB")
    if "measured" in rec:
        line += (f" card={rec['card']} ms={rec['measured']['ms']:.3f} "
                 f"estimate={m['peak_estimate_bytes'] / 2**20:.0f}MiB")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    choices=[None, "single", "multi", "card"])
    ap.add_argument("--variant", default="base",
                    help="perf-iteration tag recorded alongside results")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--amg", action="store_true",
                    help="run the distributed-AMG dry-run rows instead")
    ap.add_argument("--probe", action="store_true",
                    help="trace depth-1/2 probes (loop-cost decomposition)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the card rows (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh == "card" and dev.type != "cuda":
        ap.error("the card mesh runs on CUDA")

    if args.amg:
        from repro_torch.launch.dryrun_amg import run_amg_dryrun
        rc = run_amg_dryrun(force=args.force, device=dev)
        print(json.dumps({"device": str(dev), "results": RESULTS_PATH,
                          "rows": {k: v["status"] for k, v in
                                   _load_results().items()
                                   if k.startswith("amg-")},
                          "failures": rc}))
        return rc

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]
    meshes = ([args.mesh] if args.mesh else
              ["single", "multi"] + (["card"] if dev.type == "cuda"
                                     else []))
    depths = [1, 2] if args.probe else [None]
    results = _load_results()
    traces = {}
    failures = 0
    ran = {}
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                for depth in depths:
                    if depth is None:
                        variant = args.variant
                    elif args.variant == "base":
                        variant = f"probe-d{depth}"
                    else:
                        variant = f"{args.variant}-probe-d{depth}"
                    key = f"{arch}|{shape}|{mesh_name}|{variant}"
                    if key in results and not args.force \
                            and results[key].get("status") in ("OK",
                                                               "SKIP"):
                        print(f"[cached] {key}: {results[key]['status']}")
                        ran[key] = results[key]["status"]
                        continue
                    print(f"[run]    {key} ...", flush=True)
                    try:
                        rec = run_cell(arch, shape, mesh_name, variant,
                                       depth_override=depth, device=dev,
                                       traces=traces)
                    except Exception as e:  # record failures: they are bugs
                        rec = {"status": "FAIL", "error": repr(e),
                               "trace": traceback.format_exc()[-2000:]}
                        failures += 1
                    results[key] = rec
                    ran[key] = rec["status"]
                    _save_results({key: rec})
                    print(_summary_line(rec), flush=True)
        traces.clear()
    print(f"done; {failures} failures")
    print(json.dumps({"device": str(dev), "results": RESULTS_PATH,
                      "rows": ran, "failures": failures}))
    return 1 if failures else 0


cli = main     # the command line's entry, as every twin names it


if __name__ == "__main__":
    raise SystemExit(main())
