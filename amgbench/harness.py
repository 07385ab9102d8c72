"""One run of one cell: read the cell from ``BENCHMARK.json`` and the
files it names, set up, warm up, measure for ``--seconds``, judge, print.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` under this folder.
``limits.json`` holds the limit of every number the judging compares.
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
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BYTES_PER_GIB = 2 ** 30
#: traced windows tried before a blind one is reported as blind
TRACE_TRIES = 2


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


def load_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "amgbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
    from amgbench.reference.judge import Judge
    el = loop.econf
    j = Judge(el.m, el.E, el.nu, loop.aggregates, device)
    loop.judge(j, kept)
    return j.worst


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, src: Path | None = None,
             base: Path = HERE, window_context=contextlib.nullcontext
             ) -> dict:
    """Run ``cell`` once; returns the result line's object.
    ``window_context`` wraps the measured window (the controls plant
    their faults there)."""
    import torch

    from amgbench import generators
    from amgbench.tracing import traced

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell.chips}")
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    t = cell.traffic
    loop = generators.GENERATORS[t["generator"]](cell.config, t, seed,
                                                   device)
    loop.warmup()
    generators.sync(device)
    setup_s = time.perf_counter() - t_start
    with window_context():
        loop.window(seconds, spans=trace)
    tr = None
    if trace and device.type == "cuda":
        for _ in range(TRACE_TRIES):
            tr = loop.traced(t["traced_units"],
                               lambda units: traced(units, src))()
            if tr.complete:
                break
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    e2e = dict(loop.end_to_end(), setup_s=setup_s,
               peak_device_gib=peak / BYTES_PER_GIB)
    metrics = {}
    if trace:
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
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted, failed = loop.attempted, loop.failed
    kept = loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = judge_run(loop, kept, device)
    lim = limits(base)
    checks = {name: {"value": worst[name], "limit": lim[name]}
              for name in worst}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if trace and tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in
                                           tr.device_ops],
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    return out


def main(args, t_start: float, root: Path) -> int:
    try:
        cell = load_cell(root, args.workload)
        prepare_env(cell, bool(args.trace))
        src = root / "src"
        if not (src / "repro_torch").is_dir():
            raise Refused(f"the program is not in this checkout ({src})")
        sys.path.insert(0, str(src))
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start, src=src)
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
