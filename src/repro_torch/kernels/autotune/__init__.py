"""Kernel launch autotuner: per-signature sweeps with an on-disk cache
(torch twin of ``repro.kernels.autotune``).

The reference's Pallas kernels expose tile parameters (rows per grid
step, pair-GEMM slot tiles, panel padding).  On Hopper the matching knob
of every tuned kernel is ``threads``, the threads per CUDA block: a TPU
grid step of ``tile_rows`` rows is a block of ``threads`` work items
here.  The static default, 256, is the block size the kernels were
written with (``csrc/common.cuh`` ``kThreads``); the right value depends
on the block shape, the ELL width, the launch's size and the card.  This
module closes that loop as the reference does:

* each tuned front door takes ``threads=None`` and calls
  ``resolve_param(family, signature, "threads", None, 256, device=...)``
  (through ``launch_threads``, which also validates the result);
* the mode comes from ``repro_torch.kernels.backend.resolve_tune``
  (``REPRO_TORCH_TUNE``): "off" -> always the static default (bitwise the
  untuned launch; no file is read), "cache" (default) -> a cached winner
  when one exists, "sweep" -> measure on a miss and record the winner;
* sweeps time each candidate on synthetic operands of the signature's
  shape.  On the card each is scored by CUDA events (``device_ms``: 10
  launches queued behind a sleep kernel, median of 5 batches), and a
  candidate replaces the static 256 only when it beats 256 by more than
  ``EVENT_MARGIN`` (a host clock cannot rank differences under ~5% or
  launches under ~0.1 ms).  On the CPU
  (the plain versions) each goes through
  ``repro_torch.obs.metrics.MetricsRegistry.measure`` (the first call
  files under ``.../compile``, the rest under ``.../steady``) and the best
  *steady* time (min over repeats) wins;
* winners persist as JSON keyed by ``machine_key(device)`` then
  ``family|signature``, at ``REPRO_TORCH_TUNE_CACHE`` or
  ``~/.cache/repro_torch/autotune.json``.

Signatures are the reference's keys (block shape, ELL width ``kmax``, the
panel width ``k`` of ``block_spmm``, dtype) plus ``items``: the launch's
work-item count — block rows (``block_spmv`` and the vector
``fused_smoother``, a sub-warp each), rows x k (``block_spmm``, the
panel ``fused_smoother``), rows x bs (``pbjacobi``), tile rows x br x bc
(``fused_pair_gemm``'s output elements; a thread owns a strip of bc of
them) — rounded up to a power of two.  On Hopper the best
block size depends on how many blocks a launch spreads over the card's
132 SMs (836 block rows in blocks of 256 occupy 4 of them); a TPU grid ran
its steps in order on one core whatever the tile, so the reference needed
no such key.  Synthetic operands are built at the signature's ``items``,
so a sweep times the launch geometry the real call has.  The panel
``fused_smoother`` also carries its ``k``, as ``block_spmm`` does (the
reference's smoother keys have none), and sweeps on a panel: a panel
shares each operator block across its k columns, and on an H100 a vector
of as many rows picked 32 threads for the level-0 k=16 panel, where 32
threads run 17% slower than 256.

The TPU's ``pad_k_to`` lane padding is not carried over (``k`` is a
runtime argument of the kernels), and ``block_seg_sum`` /
``block_pair_gemm`` stay at 256 threads: the reference tunes neither.

CLI: ``python -m repro_torch.kernels.autotune smoke|sweep|show
[--device cuda|cpu]``.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import platform
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import backend

#: the static default of every ``threads`` knob: ``kThreads`` in
#: ``csrc/common.cuh``, the block size of the untuned launch
DEFAULT_THREADS = 256

# candidate grids per family, keyed by the knob's name; the static default
# each front door falls back to MUST be a member, so "sweep" can only ever
# match-or-beat the untuned launch
CANDIDATES = {
    family: {"threads": (32, 64, 128, 256, 512)}
    for family in ("block_spmv", "block_spmm", "pbjacobi", "fused_smoother",
                   "fused_pair_gemm")
}

#: on the card, the share by which a candidate's CUDA-event time must beat
#: the static 256's for the sweep to record it: ``device_ms`` of one
#: launch repeated in one process moves by a few percent (up to 4% between
#: readings in turns on an H100), so a smaller gain is not told apart from
#: noise
EVENT_MARGIN = 0.05

#: ``device_ms``: cycles of ``torch.cuda._sleep`` ahead of each batch
#: (~10 ms on an H100, enough for the host to queue the batch behind it)
SLEEP_CYCLES = 20_000_000

#: seconds between two ``stat`` calls on the cache file: the port resolves
#: at every launch (~700 a hot step), and a ``stat`` can cost tens of
#: microseconds; ``record`` and ``clear_memo`` drop the memo at once
RESTAT_S = 1.0

_memo: dict = {}


def _cache_file() -> str:
    return os.environ.get("REPRO_TORCH_TUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def cache_path() -> Path:
    """Cache file: ``REPRO_TORCH_TUNE_CACHE`` or
    ``~/.cache/repro_torch/autotune.json``.  Re-read per call so tests and
    ``chip_smoke.py`` can point the cache at a temporary file."""
    return Path(_cache_file())


@functools.lru_cache(maxsize=None)
def _card_kind(index: int) -> str:
    return f"{torch.cuda.get_device_name(index)}|{backend.source_digest()}"


def device_kind(device="cuda") -> str:
    """"cpu", or the card's name and the kernel library's source digest,
    so winners recorded for older kernel sources do not steer a rebuilt
    library (memoized per card: the digest hashes every source)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.index is None:
        dev = backend.resolve_device(dev)
    return _card_kind(dev.index)


def machine_key(device="cuda") -> str:
    """Winners are per host *and* device kind: a sweep of the plain
    versions on the CPU must never steer a card."""
    return f"{platform.node()}|{device_kind(device)}"


def entry_key(family: str, signature: dict) -> str:
    """Stable text key: ``family|k=v,...`` with sorted signature items."""
    items = ",".join(f"{k}={signature[k]}" for k in sorted(signature))
    return f"{family}|{items}"


def signature(dtype, items: int, **keys) -> dict:
    """A launch's signature: the reference's ``keys``, the dtype's name
    and ``items`` rounded up to a power of two."""
    return dict(keys, dtype=str(dtype).removeprefix("torch."),
                items=1 << max(int(items) - 1, 0).bit_length())


def clear_memo() -> None:
    """Drop the in-process cache memo (tests; the CLI smoke round-trip)."""
    _memo.clear()


def _load(path=None) -> tuple:
    """``(checked_at, mtime, data, found)`` for the cache file: ``data``
    the parsed contents ({} when absent/corrupt), memoized on the file's
    mtime, and ``found`` the lookups answered from it.  The file is
    ``stat``-ed at most once per ``RESTAT_S`` seconds, so a write by
    another process shows within that time."""
    path = _cache_file() if path is None else str(path)
    now = time.monotonic()
    hit = _memo.get(path)
    if hit is not None and now - hit[0] < RESTAT_S:
        return hit
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    if hit is not None and hit[1] == mtime:
        data, found = hit[2], hit[3]
    else:
        data, found = {}, {}
        if mtime is not None:
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                pass
    _memo.clear()                   # one live file at a time
    _memo[path] = entry = (now, mtime, data, found)
    return entry


def load_cache(path: Path | None = None) -> dict:
    """Parsed cache contents ({} when absent/corrupt), memoized."""
    return _load(path)[2]


def lookup(family: str, signature: dict, name: str, device="cuda"):
    """Cached winner for one knob on ``device``'s kind, or None.  Each
    answer is memoized with the file's contents, so a launch's lookup
    costs a dict probe (the port resolves at every launch)."""
    _, _, data, found = _load()
    key = (family, name, device, tuple(signature.items()))
    if key not in found:
        entry = data.get(machine_key(device), {}).get(
            entry_key(family, signature))
        found[key] = None if entry is None else \
            entry.get("params", {}).get(name)
    return found[key]


def record(family: str, signature: dict, params: dict,
           best_us: float | None = None, device="cuda") -> Path:
    """Merge one signature's winning params into the cache (atomic
    write)."""
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    cache = dict(load_cache(path))
    key = machine_key(device)
    mk = cache[key] = dict(cache.get(key, {}))
    mk[entry_key(family, signature)] = {
        "params": dict(params),
        "best_us": best_us,
        "recorded": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    clear_memo()
    return path


def resolve_param(family: str, signature: dict, name: str, requested,
                  default, device="cuda"):
    """One knob through the mode ladder.

    requested != None  -> the caller pinned it; use verbatim.
    mode "off"         -> the static default (bitwise untuned).
    mode "cache"       -> cached winner if present, else the default.
    mode "sweep"       -> cached winner if present, else sweep this
                          signature on ``device`` now, record, and use the
                          winner.
    """
    if requested is not None:
        return requested
    mode = backend.resolve_tune(None)
    if mode == "off":
        return default
    hit = lookup(family, signature, name, device)
    if hit is not None:
        return hit
    if mode == "sweep":
        won = sweep(family, signature, device=device)
        return won["params"].get(name, default)
    return default


def launch_threads(family: str, signature: dict, threads, device) -> int:
    """A tuned front door's ``threads``: resolved (``threads=None`` goes
    through the ladder with the static default 256) and validated."""
    threads = resolve_param(family, signature, "threads", threads,
                            DEFAULT_THREADS, device=device)
    backend.check_threads(family, threads)
    return threads


# ---------------------------------------------------------------------------
# Sweeping
# ---------------------------------------------------------------------------

def _rows(family: str, signature: dict) -> int:
    """Synthetic rows that give the signature's ``items`` work items (256
    for a signature without ``items``, the reference's default)."""
    items = signature.get("items")
    if items is None:
        return 256
    per_row = {"block_spmm": signature.get("k", 1),
               "fused_smoother": signature.get("k", 1),
               "pbjacobi": signature.get("bs", 1),
               "fused_pair_gemm": signature.get("br", 1)
               * signature.get("bc", 1)}.get(family, 1)
    return max(1, items // per_row)


def _synthetic(family: str, signature: dict, nbr: int, device) -> dict:
    """Deterministic operands of the signature's shape and dtype (f64, f32
    or bf16) on ``device``: indices and operator blocks from numpy seed 0
    (the reference's), the vectors from seed 1, drawn at f64 and rounded to
    the signature's dtype."""
    rng = np.random.default_rng(0)
    fdt = backend.as_dtype(signature["dtype"])

    def t(a):
        a = torch.as_tensor(a)
        return a.to(device, fdt if a.is_floating_point() else a.dtype)

    if family == "fused_pair_gemm":
        br, bk, bc, kmax = (signature[k] for k in ("br", "bk", "bc", "kmax"))
        return dict(
            a=t(rng.standard_normal((nbr, br, bk))),
            b=t(rng.standard_normal((nbr, bk, bc))),
            ta=t(rng.integers(0, nbr, size=(nbr, kmax)).astype(np.int32)),
            tb=t(rng.integers(0, nbr, size=(nbr, kmax)).astype(np.int32)),
            mask=t(np.ones((nbr, kmax), dtype=bool)))
    vec = np.random.default_rng(1)
    if family == "pbjacobi":
        bs = signature["bs"]
        return dict(dinv=t(vec.standard_normal((nbr, bs, bs))),
                    r=t(vec.standard_normal(nbr * bs)),
                    x=t(vec.standard_normal(nbr * bs)))
    br, bc, kmax = signature["br"], signature["bc"], signature["kmax"]
    nbc = nbr                      # square-ish synthetic operator
    ops = dict(
        indices=t(rng.integers(0, nbc, size=(nbr, kmax)).astype(np.int32)),
        data=t(rng.standard_normal((nbr, kmax, br, bc))))
    if family == "block_spmv":
        ops["x"] = t(vec.standard_normal((nbc, bc)))
    elif family == "block_spmm":
        ops["x"] = t(vec.standard_normal((nbc, bc, signature["k"])))
    elif family == "fused_smoother":
        cols = (signature["k"],) if "k" in signature else ()
        ops.update(dinv=t(vec.standard_normal((nbr, br, br))),
                   b=t(vec.standard_normal((nbr, br) + cols)),
                   x=t(vec.standard_normal((nbr, br) + cols)),
                   d=t(np.zeros((nbr, br) + cols)),
                   coef=t(np.array([0.0, 0.5])))
    else:
        raise ValueError(f"unknown autotune family {family!r}")
    return ops


def _make_runner(family: str, params: dict, ops: dict):
    """Closure running one kernel call on the synthetic operands."""
    if family == "fused_pair_gemm":
        from repro_torch.kernels.fused_pair_gemm import ops as _f
        return lambda: _f.fused_pair_gemm(ops["a"], ops["b"], ops["ta"],
                                          ops["tb"], ops["mask"], **params)
    if family == "pbjacobi":
        from repro_torch.kernels.pbjacobi import ops as _p
        return lambda: _p.pbjacobi_apply(ops["dinv"], ops["r"], ops["x"],
                                         0.6, **params)
    if family == "block_spmv":
        from repro_torch.kernels.block_spmv import ops as _s
        return lambda: _s.block_spmv_ell(ops["indices"], ops["data"],
                                         ops["x"], **params)
    if family == "block_spmm":
        from repro_torch.kernels.block_spmm import ops as _m
        return lambda: _m.block_spmm_ell(ops["indices"], ops["data"],
                                         ops["x"], **params)
    if family == "fused_smoother":
        from repro_torch.kernels.fused_smoother import ops as _fs
        return lambda: _fs.smoother_step_ell(
            ops["indices"], ops["data"], ops["dinv"], ops["b"], ops["x"],
            ops["d"], ops["coef"], **params)
    raise ValueError(f"unknown autotune family {family!r}")


def _param_grid(family: str):
    """Cartesian candidate grid as a list of param dicts."""
    cands = CANDIDATES[family]
    names = sorted(cands)
    return [dict(zip(names, vals))
            for vals in itertools.product(*(cands[n] for n in names))]


def device_ms(fn, launches: int = 10, reps: int = 5) -> float:
    """Median device milliseconds per call of ``fn()`` on the card:
    ``launches`` calls queued behind a sleep kernel between two CUDA
    events, so the card runs them back to back and the host's enqueue time
    is not counted (as long as the host queues the batch within the
    sleep)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def launch_record() -> tuple:
    """``(launches, blocks, threads)``: how many kernels the library's entry
    points have launched in this process, and the grid of the latest, as
    the C side notes them just before each launch (no profiler needed)."""
    import ctypes
    out = (ctypes.c_longlong * 3)()
    backend.kernel("repro_launch_record", (backend.P,))(out)
    return tuple(int(v) for v in out)


def launch_floor_ms(blocks: int, threads: int) -> float:
    """``device_ms`` of the empty kernel (``csrc/launch_floor.cu``) at a
    ``blocks`` x ``threads`` grid: the card's floor for one launch of that
    shape, set beside kernels that run a few microseconds."""
    args = (backend.I, backend.I, backend.P)
    return device_ms(lambda: backend.launch("repro_empty_kernel", args,
                                            blocks, threads))


def sweep(family: str, signature: dict, *, nbr: int | None = None,
          repeats: int = 3, device="cuda", record_winner: bool = True
          ) -> dict:
    """Time every candidate for one signature on ``device``; record the
    winner under that device's machine key.

    Operands are synthetic, at the signature's ``items`` (``nbr`` rows
    when given).  On the card each candidate is scored by ``device_ms``
    (CUDA events), and the winner is the static ``DEFAULT_THREADS``
    unless the fastest candidate beats it by more than ``EVENT_MARGIN``.
    On the CPU, where every candidate runs the same plain version, each is
    measured through ``MetricsRegistry.measure`` — the first call files
    under ``.../compile``, the following ``repeats`` under ``.../steady``
    — and scored by its *min* steady seconds.  Returns ``{"params",
    "best_us", "table"}`` (``table`` maps the candidate key to its best
    microseconds).
    """
    if family not in CANDIDATES:
        raise ValueError(f"unknown autotune family {family!r}")
    from repro_torch.obs.metrics import MetricsRegistry
    dev = backend.resolve_device(device)
    rows = nbr if nbr is not None else _rows(family, signature)
    ops = _synthetic(family, signature, rows, dev)
    reg = MetricsRegistry()
    best = None
    table = {}
    for params in _param_grid(family):
        fn = _make_runner(family, params, ops)
        key = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
        if dev.type == "cuda":
            us = device_ms(fn) * 1e3
        else:
            name = f"tune/{family}/{key}"
            for _ in range(repeats + 1):
                reg.measure(name, fn)
            us = reg.get(name + "/steady").snapshot()["min"] * 1e6
        table[key] = us
        if best is None or us < best[1]:
            best = (params, us)
    static = {"threads": DEFAULT_THREADS}
    static_us = table[f"threads={DEFAULT_THREADS}"]
    if dev.type == "cuda" and best[1] >= static_us * (1 - EVENT_MARGIN):
        best = (static, static_us)
    won = {"params": best[0], "best_us": best[1], "table": table}
    if record_winner:
        record(family, signature, best[0], best_us=best[1], device=dev)
    return won
