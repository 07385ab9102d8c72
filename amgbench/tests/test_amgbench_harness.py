"""The harness's layout and hygiene: cells, traffic mixes and per-layer
metrics found by name from files of their own; no JAX; the run's
environment; refusals."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from amgbench_cells import ROOT, small_root
from amgbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_existing_files():
    for conf in BENCH["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"]
        assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    for w in BENCH["workloads"]:
        assert (ROOT / "amgbench" / "traffic" / f"{w['traffic']}.json") \
            .exists()
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    assert set(json.loads((ROOT / "amgbench" / "limits.json").read_text())) \
        == set(__import__("amgbench.reference.judge",
                          fromlist=["CHECKS"]).CHECKS)


def _dummy_cell(tmp_path, generator=None, reader="dummy_steps.dummy",
                reads="float(len(ctx['solve_s']))"):
    """A new configuration, traffic mix (of ``generator``, or of the
    coefficient loop) and per-layer metric, added as files with a
    manifest entry, in a copy of the harness's data; the cell, ``base``."""
    root = small_root(tmp_path)
    base = tmp_path / "amgbench"
    for sub in ("traffic", "metrics"):
        shutil.copytree(ROOT / "amgbench" / sub, base / sub,
                        dirs_exist_ok=True)
    shutil.copy(ROOT / "amgbench" / "limits.json", base / "limits.json")
    cfg = json.loads((root / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy-config"
    cfg["elasticity"].update(m=8, coarse_size=16)
    (base / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "coeff.json").read_text())
    traffic["inclusion"]["radius"] = 0.2
    if generator:
        traffic["generator"] = generator
    (base / "traffic" / "dummy-traffic.json").write_text(json.dumps(traffic))
    (base / "metrics" / f"{reader}.py").write_text(
        f"def read(ctx):\n    return {reads}\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(BENCH["configs"][0], name="dummy-config",
                                    file="amgbench/configs/dummy-config.json"))
    manifest["workloads"].append({"name": "dummy.cell",
                                  "config": "dummy-config",
                                  "traffic": "dummy-traffic", "chips": 1,
                                  "why": "test"})
    manifest["per_layer"].append({
        "name": reader, "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "solve", "moves": "hot_step_ms",
        "workloads": ["dummy.cell"]})
    manifest["end_to_end"][1]["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell(root, "dummy.cell", base=base)
    harness.prepare_env(cell)
    return cell, base


def _tree():
    return {p: p.read_bytes() for p in (ROOT / "amgbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_runs_from_added_files_only(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files with a manifest entry, run without an edit to any file."""
    before = _tree()
    cell, base = _dummy_cell(tmp_path)
    out = harness.run_cell(cell, 7, 0.5, True, time.perf_counter(),
                           device="cpu", base=base)
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_steps.dummy"]["value"] >= 1
    assert "cg_iterations.coeff" not in out["metrics"]   # not listed there
    out = harness.run_cell(cell, 7, 0.5, False, time.perf_counter(),
                           device="cpu", base=base)
    assert set(out["metrics"]) == {"setup_s", "hot_step_ms",
                                   "peak_device_gib"}
    assert list(out)[-1] == "checks"
    assert _tree() == before


ADDED_LOOP = '''"""The coefficient loop, found by its file's name."""
from amgbench.generators import CoefficientLoop


class Loop(CoefficientLoop):
    def layer_context(self, trace):
        return dict(super().layer_context(trace), loop_file=__file__)
'''


def test_new_loop_file_runs_on_one_chip(tmp_path):
    """A traffic mix whose generator is a loop in a new file under
    ``loops/``: the cell runs in this process, with its judge."""
    before = _tree()
    cell, base = _dummy_cell(tmp_path, generator="dummy_loop",
                             reader="dummy_loop_file.dummy",
                             reads="float(ctx['loop_file'].endswith("
                                   "'dummy_loop.py'))")
    (base / "loops").mkdir()
    (base / "loops" / "dummy_loop.py").write_text(ADDED_LOOP)
    out = harness.run_cell(cell, 7, 0.5, True, time.perf_counter(),
                           device="cpu", base=base)
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_loop_file.dummy"]["value"] == 1.0
    assert out["device"]["count"] == 1
    assert list(out["checks"]) == list(harness.limits())
    assert _tree() == before
    cell.traffic = dict(cell.traffic, generator="no_such_loop")
    with pytest.raises(harness.Refused, match="no_such_loop"):
        harness.run_cell(cell, 7, 0.5, False, time.perf_counter(),
                         device="cpu", base=base)


@pytest.mark.parametrize("traffic", ["coeff", "serve"])
def test_make_judge_is_the_whole_cube_judge(traffic):
    """Each loop's own judge gives what the harness's judge of one whole
    Q1 cube on the set-up aggregates gave (m=8, one step or round)."""
    import torch
    from amgbench.reference.judge import Judge
    cfg = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    cfg["elasticity"].update(m=8, coarse_size=16)
    t = json.loads((ROOT / "amgbench" / "traffic" / f"{traffic}.json")
                   .read_text())
    cpu = torch.device("cpu")
    loop = harness.load_loop(t["generator"])(cfg, t, 5, cpu)
    loop.warmup()
    loop.window(1e-3, spans=False)
    assert loop.attempted >= 1
    kept = loop.release()
    el = loop.econf
    whole = Judge(el.m, el.E, el.nu, loop.aggregates, cpu)
    loop.judge(whole, kept)
    assert harness.judge_run(loop, kept, cpu) == whole.worst


_MODULES = """
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
import amgbench.reference.fem, amgbench.reference.blocked
import amgbench.reference.hierarchy, amgbench.reference.judge
ref = sorted({{m.split('.')[0] for m in sys.modules}})
from amgbench import harness, generators, tracing, work, control
import amgbench.run
for m in json.loads(Path({bench!r}).read_text())["per_layer"]:
    harness.load_reader(m["name"])
import repro_torch.configs.elasticity, repro_torch.multirhs
import repro_torch.core.gamg, repro_torch.kernels.autotune
print(json.dumps([ref, sorted({{m.split('.')[0] for m in sys.modules}})]))
"""


def test_no_jax_and_a_reference_without_the_program():
    code = _MODULES.format(root=str(ROOT), src=str(ROOT / "src"),
                           bench=str(ROOT / "BENCHMARK.json"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    ref, everything = json.loads(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" not in ref
    assert "repro_torch" in everything
    for name in harness.FORBIDDEN:
        assert name not in everything


def test_forbidden_names_compared_whole():
    assert harness.loaded_forbidden(
        ["repro_torch.core.gamg", "reprox", "jaxtyping", "flaxen"]) == []
    assert harness.loaded_forbidden(
        ["repro.core.gamg", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_environment_of_a_run(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "pairs")
    monkeypatch.setenv("REPRO_TORCH_PRECISION", "bf16")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    cell = harness.load_cell(ROOT, BENCH["workloads"][0]["name"])
    cell.config = dict(cell.config, env={"REPRO_TORCH_OBS": "off"})
    harness.prepare_env(cell)
    knobs = {k: v for k, v in os.environ.items()
             if k.startswith("REPRO_TORCH_")}
    assert knobs == {"REPRO_TORCH_OBS": "off",
                     "REPRO_TORCH_TUNE_CACHE": str(
                         tmp_path / "amgbench" / "autotune.json")}
    # a traced run adds the traffic's own knobs (the program's spans)
    harness.prepare_env(cell, trace=True)
    assert os.environ["REPRO_TORCH_OBS"] == \
        cell.traffic["traced_env"]["REPRO_TORCH_OBS"]


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "amgbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_refuses_without_a_card():
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "amgbench", tmp_path / "amgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cell_on_the_card(card, tmp_path):
    """A short run of the smallest cell through ``run.py`` on the card."""
    name = next(w["name"] for w in BENCH["workloads"]
                if w["name"].startswith("m32"))
    p = subprocess.run(
        [sys.executable, "amgbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
