"""One run of one cell: read the cell from ``BENCHMARK.json`` and the
files it names, set up, warm up, measure for ``--seconds``, judge, print.

Everything that belongs to one configuration, traffic mix, loop or
per-layer metric is found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``loops/<generator>.py`` (a generator that
is not one of ``generators.GENERATORS``) and ``metrics/<metric>.py``
under this folder.  ``limits.json`` holds the limit of every number the
judging compares.

A cell on one chip runs in this process.  A cell on several runs one
rank process a card (``run_ranks``), each through the whole of a run;
this process merges their parts (``merge``) and alone prints the result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BYTES_PER_GIB = 2 ** 30
#: traced windows tried before a blind one is reported as blind
TRACE_TRIES = 2
#: seconds a run on several chips may take beyond ``--seconds`` (the
#: ranks' start, set-up, traced units, judging and exit) before its
#: watchdog kills every rank: at 20 s a run it ends within the 360 s a
#: run is given
RANK_ALLOWANCE_S = 300


class Refused(Exception):
    """A run that cannot be measured: exit non-zero, print no result."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list         # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its
    configuration and traffic files (under ``base``)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, workload)])


def prepare_env(cell: Cell, trace: bool = False) -> None:
    """Only the knobs the cell's files set reach the program (a traced
    run adds the traffic's ``traced_env``); the autotuner's cache file
    sits in this run's temporary directory."""
    wanted = {**cell.config.get("env", {}), **cell.traffic.get("env", {}),
              **(cell.traffic.get("traced_env", {}) if trace else {})}
    for key in [k for k in os.environ if k.startswith("REPRO_TORCH_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in wanted.items()})
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "amgbench", "autotune.json")


def _load_file(path: Path, prefix: str, name: str):
    """The module of the file ``path``, under a name of its own, loaded
    once a process: a loop's faults patch the class the run builds."""
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = sys.modules.get(spec.name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load_file(base / "metrics" / f"{name}.py", "amgbench_metric_",
                      name).read


def loop_file(generator: str, base: Path = HERE):
    """The module of ``loops/<generator>.py``."""
    from amgbench import generators
    path = base / "loops" / f"{generator}.py"
    if not path.is_file():
        raise Refused(f"no generator {generator!r}: not one of "
                      f"{sorted(generators.GENERATORS)} and no {path}")
    return _load_file(path, "amgbench_loop_", generator)


def load_loop(generator: str, base: Path = HERE):
    """The loop class a traffic file's ``generator`` names: one of
    ``generators.GENERATORS``, or the ``Loop`` of
    ``loops/<generator>.py``."""
    from amgbench import generators
    if generator in generators.GENERATORS:
        return generators.GENERATORS[generator]
    return loop_file(generator, base).Loop


def loaded_forbidden(modules=None) -> list:
    """Forbidden top-level names among ``modules`` (default: every
    loaded module), each name compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def limits(base: Path = HERE) -> dict:
    return json.loads((base / "limits.json").read_text())


def judge_run(loop, kept, device) -> dict:
    """Every compared number of the run, worst over what was judged."""
    j = loop.make_judge(device)
    loop.judge(j, kept)
    return j.worst


def _need_cards(chips: int) -> None:
    """Refuse a run without ``chips`` CUDA devices (creates no context)."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                      f"cell asks for {chips}")


def _no_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_part(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device, src: Path | None = None,
             base: Path = HERE, window_context=contextlib.nullcontext
             ) -> dict:
    """This process's part of one run of ``cell`` on ``device``: set-up,
    warm-up, window, traced units, the layers' readings, judging.

    In a rank process (the default ``torch.distributed`` group is up)
    set-up ends at a barrier every rank reaches after its warm-up, every
    rank traces its units, and they run again while any rank's trace is
    blind; only the lead (rank 0) takes end-to-end metrics and layers'
    readings.  ``window_context`` wraps the measured window (the
    controls plant their faults there)."""
    import torch
    import torch.distributed as tdist

    from amgbench import generators
    from amgbench.tracing import traced

    ranked = tdist.is_available() and tdist.is_initialized()
    lead = not ranked or tdist.get_rank() == 0
    t = cell.traffic
    loop = load_loop(t["generator"], base)(cell.config, t, seed, device)
    loop.warmup()
    generators.sync(device)
    if ranked:
        tdist.barrier()
    setup_s = time.perf_counter() - t_start
    with window_context():
        loop.window(seconds, spans=trace)
    tr = None
    if trace and device.type == "cuda":
        for _ in range(TRACE_TRIES):
            tr = loop.traced(t["traced_units"],
                             lambda units: traced(units, src))()
            complete = [tr.complete]
            if ranked:
                complete = [None] * tdist.get_world_size()
                tdist.all_gather_object(complete, tr.complete)
            if all(complete):
                break
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    part = {"setup_s": setup_s, "peak": peak, "e2e": {}, "layers": {},
            "trace": None,
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"}
    if lead:
        part["e2e"] = loop.end_to_end()
    if trace and lead:
        ctx = loop.layer_context(tr)
        if tr is not None:
            print(f"trace: {tr.device_events} device events, "
                  f"{tr.linked_events} linked to their launch, "
                  f"{tr.library_events} library events for "
                  f"{tr.library_launches} launches"
                  + ("" if tr.complete else " (blind: no device metric)"),
                  file=sys.stderr)
            if not tr.complete:
                ctx["trace"] = None
        for m in cell.per_layer:
            v = load_reader(m["name"], base)(ctx)
            if v is not None:
                part["layers"][m["name"]] = v
    if tr is not None:
        part["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                         "complete": tr.complete,
                         "device_ops": [[n[:120], s]
                                        for n, s in tr.device_ops],
                         "idle_gaps": tr.idle_gaps}
    part["attempted"], part["failed"] = loop.attempted, loop.failed
    kept = loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    part["worst"] = judge_run(loop, kept, device)
    return part


def _worse(a: float, b: float) -> float:
    """The larger gap; a NaN stays a NaN."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


def merge(cell: Cell, parts: list, trace: bool, base: Path = HERE) -> dict:
    """The result line's object from every rank's part, the lead's first:
    the lead's end-to-end metrics, ``attempted``, readings, window and
    breakdown; the slowest rank's ``setup_s``, the fullest card's peak,
    the most ``failed`` and the largest gap of each check over the ranks.
    ``busy_s`` is the mean over the cards of the busy share of each
    rank's own traced window, ranks with a blind trace left out, times
    the lead's window (one card: its own reading).  Refuses a check
    ``limits.json`` has no limit for."""
    lead = parts[0]
    peak = max(p["peak"] for p in parts)
    if trace:
        metrics = {m["name"]: {"value": lead["layers"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in lead["layers"]}
    else:
        e2e = dict(lead["e2e"], setup_s=max(p["setup_s"] for p in parts),
                   peak_device_gib=peak / BYTES_PER_GIB)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    worst = dict(lead["worst"])
    for p in parts[1:]:
        for name, v in p["worst"].items():
            worst[name] = _worse(worst[name], v) if name in worst else v
    lim = limits(base)
    unknown = sorted(set(worst) - set(lim))
    if unknown:
        raise Refused(f"checks without a limit in limits.json: {unknown}")
    checks = {name: {"value": worst[name], "limit": lim[name]}
              for name in worst}
    failed = max(p["failed"] for p in parts)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    out = {"correct": correct, "attempted": lead["attempted"],
           "failed": failed, "metrics": metrics,
           "device": {"platform": lead["platform"], "kind": lead["kind"],
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if trace and lead["trace"] is not None:
        window = lead["trace"]["window_s"]
        busy = lead["trace"]["busy_s"]
        seen = [p["trace"] for p in parts
                if p["trace"] and p["trace"]["complete"]]
        if len(parts) > 1 and seen:
            busy = window * sum(t["busy_s"] / t["window_s"]
                                for t in seen) / len(seen)
        out["device"].update(busy_s=busy, window_s=window)
        out["breakdown"] = {"device_ops": lead["trace"]["device_ops"],
                            "idle_gaps": lead["trace"]["idle_gaps"]}
    out["checks"] = checks
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, src: Path | None = None,
             base: Path = HERE, window_context=contextlib.nullcontext
             ) -> dict:
    """Run ``cell`` once in this process, on ``cuda:0`` unless
    ``device`` is given; returns the result line's object."""
    import torch
    if device is None:
        _need_cards(cell.chips)
        device = torch.device("cuda", 0)
        _no_tf32()
    part = run_part(cell, seed, seconds, trace, t_start,
                    torch.device(device), src, base, window_context)
    return merge(cell, [part], trace, base)


def _rank(rank: int, cell: Cell, seed: int, seconds: float, trace: bool,
          t_start: float, on_cards: bool, src: Path | None, base: Path,
          rendezvous: str, fault: str | None, env: dict, out) -> None:
    """One rank process (``sys.path`` as its parent's): its card, the
    group, its part of the run, under the fault of ``control.py`` named
    ``fault`` if one is.  The part, or the traceback of what the rank
    raised, is sent through ``out``."""
    try:
        import torch
        import torch.distributed as tdist
        prepare_env(cell, trace)
        os.environ.update(env)
        broken = contextlib.nullcontext
        if fault:
            from amgbench import control
            broken = control.faults(cell.traffic["generator"], base)[fault]
        if on_cards:
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            _no_tf32()
            tdist.init_process_group(
                "nccl", init_method=rendezvous, world_size=cell.chips,
                rank=rank, device_id=device)
        else:
            device = torch.device("cpu")
            tdist.init_process_group(
                "gloo", init_method=rendezvous, world_size=cell.chips,
                rank=rank)
        part = run_part(cell, seed, seconds, trace, t_start, device, src,
                        base, broken)
        bad = loaded_forbidden()
        if bad:
            raise Refused(f"modules loaded that the port must not use: "
                          f"{bad}")
    except Exception:
        # the other ranks may wait in a collective: the parent kills them
        out.send(("error", traceback.format_exc()))
        raise SystemExit(1)
    out.send(("part", part))
    tdist.destroy_process_group()


def run_ranks(cell: Cell, seed: int, seconds: float, trace: bool,
              t_start: float, device=None, src: Path | None = None,
              base: Path = HERE, watchdog_s: float | None = None,
              fault: str | None = None, env: dict | None = None) -> dict:
    """Run ``cell`` as ``cell.chips`` rank processes, rank ``r`` on
    ``cuda:r`` under NCCL (``device="cpu"``: every rank on the CPU under
    gloo), meeting at a file under this run's temporary directory;
    returns the result line's object, merged here from their parts.
    ``fault`` (a name ``control.faults`` knows) and ``env`` (set after
    ``prepare_env``) are the controls', and reach every rank.

    ``t_start`` is this process's ``time.perf_counter()`` at start, a
    clock every process of the machine shares.  If a rank raises or ends
    without its part, or the parts have not all come within
    ``watchdog_s`` (``seconds + RANK_ALLOWANCE_S``), every rank is killed
    and the run is refused."""
    import multiprocessing
    import shutil
    from multiprocessing.connection import wait

    import torch
    on_cards = device is None or torch.device(device).type == "cuda"
    if on_cards:
        _need_cards(cell.chips)
    limit = seconds + RANK_ALLOWANCE_S if watchdog_s is None else watchdog_s
    deadline = time.monotonic() + limit
    mp = multiprocessing.get_context("spawn")
    where = tempfile.mkdtemp(prefix="amgbench-ranks-")
    rendezvous = "file://" + os.path.join(where, "rendezvous")
    pipes = [mp.Pipe(duplex=False) for _ in range(cell.chips)]
    procs = [mp.Process(target=_rank, name=f"amgbench-rank-{r}",
                        args=(r, cell, seed, seconds, trace, t_start,
                              on_cards, src, base, rendezvous, fault,
                              env or {}, send))
             for r, (_, send) in enumerate(pipes)]
    waiting = {recv: r for r, (recv, _) in enumerate(pipes)}
    parts = {}
    try:
        for p, (_, send) in zip(procs, pipes):
            p.start()
            send.close()       # a rank that ends is then seen at its end
        while waiting:
            ready = wait(list(waiting),
                         timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                raise Refused(f"the ranks gave no result within the "
                              f"watchdog's {limit:g} s")
            for recv in ready:
                r = waiting.pop(recv)
                try:
                    kind, got = recv.recv()
                except EOFError:
                    procs[r].join(1.0)
                    raise Refused(f"rank {r} ended with exit code "
                                  f"{procs[r].exitcode} and no part") \
                        from None
                if kind == "error":
                    raise Refused(f"rank {r} raised:\n{got}")
                parts[r] = got
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        for recv, _ in pipes:
            recv.close()
        shutil.rmtree(where, ignore_errors=True)
    return merge(cell, [parts[r] for r in range(len(procs))], trace, base)


def main(args, t_start: float, root: Path, device=None, base: Path = HERE,
         watchdog_s: float | None = None) -> int:
    """One run from ``run.py``'s arguments; prints the result.  A cell on
    one chip runs in this process, one on several in rank processes.
    ``device``, ``base`` and ``watchdog_s`` are for the tests."""
    try:
        cell = load_cell(root, args.workload, base)
        prepare_env(cell, bool(args.trace))
        src = root / "src"
        if not (src / "repro_torch").is_dir():
            raise Refused(f"the program is not in this checkout ({src})")
        sys.path.insert(0, str(src))
        if cell.chips > 1:
            out = run_ranks(cell, args.seed, args.seconds, bool(args.trace),
                            t_start, device=device, src=src, base=base,
                            watchdog_s=watchdog_s)
        else:
            out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start, device=device, src=src, base=base)
    except Refused as e:
        print(f"amgbench: {e}", file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"amgbench: modules loaded that the port must not use: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
