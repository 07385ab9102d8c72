"""A cell on several chips: one rank process a card (on the CPU here,
under gloo), its loop and judge found by file name.  A toy loop, written
with its traffic, configuration and reader into a temporary folder, runs
on two ranks; the harness merges their parts into one result, and a rank
that raises or hangs ends the run with no result."""
import argparse
import json
import math
import multiprocessing
import shutil
import time

import pytest

from amgbench_cells import ROOT
from amgbench import control, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2147483677

TOY_LOOP = '''"""Rows of a matrix a rank, made from the seed and the rank; a step
multiplies them by the step's vector and sums the products over the
ranks in one allreduce, which also carries the lead's word that the
window is over.  ``plant`` breaks one rank on purpose, and so do the
``FAULTS`` while the window runs; ``REPRO_TORCH_PRECISION=f32`` makes
the products in float32."""
import contextlib
import os
import random
import time

import torch
import torch.distributed as tdist


def rows(seed, rank, n):
    g = torch.Generator().manual_seed((seed * 1009 + rank) % 2 ** 63)
    return torch.randn((n, n), generator=g, dtype=torch.float64)


def vector(seed, i, n):
    g = torch.Generator().manual_seed((seed * 1000003 + i) % 2 ** 63)
    return torch.randn(n, generator=g, dtype=torch.float64)


class Judge:
    """The sum over every rank's rows, from the seed alone."""

    def __init__(self, seed, world, n, name):
        self.seed, self.n, self.name = seed, n, name
        self.A = sum(rows(seed, r, n) for r in range(world))
        self.worst = {name: 0.0}

    def product(self, i, y):
        ref = self.A @ vector(self.seed, i, self.n)
        gap = float((y.cpu() - ref).abs().max() / ref.abs().max())
        if not gap <= self.worst[self.name]:
            self.worst[self.name] = gap


class Loop:
    def __init__(self, cfg, traffic, seed, device):
        self.rank, self.world = tdist.get_rank(), tdist.get_world_size()
        self.seed, self.device, self.n = seed, device, traffic["n"]
        self.A = rows(seed, self.rank, self.n).to(device)
        # held to the end of the window: the ranks' peaks differ
        self.pad = torch.ones(traffic["pad_bytes"] * (self.rank + 1),
                              dtype=torch.uint8, device=device)
        self.plant = traffic.get("plant", {}).get(str(self.rank))
        self.judge_at = random.Random(seed).randrange(traffic["judge_first"])
        self.steps, self.kept, self.failures = 0, [], 0

    def step(self, i, stop=False):
        y = self.A @ vector(self.seed, i, self.n).to(self.device)
        if os.environ.get("REPRO_TORCH_PRECISION") == "f32":
            y = (self.A.float() @ vector(self.seed, i, self.n).float()
                 .to(self.device)).double()
        buf = torch.cat([y, torch.tensor([float(stop)], dtype=y.dtype,
                                         device=self.device)])
        tdist.all_reduce(buf)
        return buf[:-1], bool(buf[-1] > 0)

    def warmup(self):
        if self.plant == "raise":
            raise RuntimeError("planted: this rank raised in its warm-up")
        if self.plant == "hang":
            time.sleep(3600)
        self.step(0)

    def window(self, seconds, spans):
        t0 = time.perf_counter()
        while True:
            over = self.rank == 0 and time.perf_counter() - t0 >= seconds
            y, over = self.step(self.steps, over)
            if over:
                break
            if self.plant == "wrong":
                y[len(y) // 3] *= 1.01
            if not bool(torch.isfinite(y).all()):
                self.failures += 1
            if self.steps == self.judge_at:
                self.kept.append((self.steps, y))
            self.last = (self.steps, y)
            self.steps += 1
        self.window_s = time.perf_counter() - t0
        self.next = self.steps

    def traced(self, n, tracer):
        first, self.next = self.next, self.next + n

        def units():
            for i in range(first, first + n):
                self.step(i)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return tracer(units)

    def end_to_end(self):
        return {"hot_step_ms": 1e3 * self.window_s / self.steps}

    @property
    def attempted(self):
        return self.steps

    @property
    def failed(self):
        return self.failures

    def layer_context(self, trace):
        return {"trace": trace, "steps": self.steps}

    def release(self):
        kept = self.kept + [self.last]
        self.A = self.pad = self.kept = self.last = None
        return kept

    def make_judge(self, device):
        name = "unlisted" if self.plant == "unlisted" else "residual"
        return Judge(self.seed, self.world, self.n, name)

    def judge(self, judge, kept):
        for i, y in kept:
            judge.product(i, y)


def _patched(rank, make):
    """``Loop.step`` replaced by ``make(old)`` on ``rank`` (every rank:
    None) while the window runs."""
    @contextlib.contextmanager
    def fault():
        old = Loop.step
        if rank is None or tdist.get_rank() == rank:
            Loop.step = make(old)
        try:
            yield
        finally:
            Loop.step = old
    return fault


def _altered(old):
    def step(self, i, stop=False):
        y, over = old(self, i, stop)
        y[len(y) // 3] *= 1.01
        return y, over
    return step


def _unexchanged(old):
    def step(self, i, stop=False):
        y = self.A @ vector(self.seed, i, self.n).to(self.device)
        flag = torch.tensor([float(stop)], device=self.device)
        tdist.all_reduce(flag)
        return y, bool(flag[0] > 0)
    return step


FAULTS = {"answer_altered": _patched(1, _altered),
          "exchange_left_out": _patched(None, _unexchanged)}
'''


def toy_root(tmp_path, plant=None, chips=2):
    """A checkout whose ``BENCHMARK.json`` adds the toy cell ``toy.ranks``
    and whose harness folder adds its loop, traffic, configuration and
    per-layer reader; the program is the repository's."""
    root, base = tmp_path / "root", tmp_path / "root" / "amgbench"
    for sub in ("traffic", "metrics"):
        shutil.copytree(ROOT / "amgbench" / sub, base / sub)
    shutil.copy(ROOT / "amgbench" / "limits.json", base / "limits.json")
    (root / "src").symlink_to(ROOT / "src")
    (base / "loops").mkdir()
    (base / "loops" / "toy_ranks.py").write_text(TOY_LOOP)
    (base / "configs").mkdir()
    (base / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "reduced": []}))
    (base / "traffic" / "toy.json").write_text(json.dumps(
        {"generator": "toy_ranks", "n": 96, "pad_bytes": 2 ** 20,
         "judge_first": 3, "traced_units": 2, "plant": plant or {}}))
    (base / "metrics" / "toy_steps.toy.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    manifest = json.loads(json.dumps(BENCH))
    manifest["configs"].append({"name": "toy", "source": "test",
                                "file": "amgbench/configs/toy.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "toy.ranks", "config": "toy",
                                  "traffic": "toy", "chips": chips,
                                  "why": "test"})
    next(m for m in manifest["end_to_end"]
         if m["name"] == "hot_step_ms")["workloads"].append("toy.ranks")
    manifest["per_layer"].append({
        "name": "toy_steps.toy", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "solve",
        "moves": "hot_step_ms", "workloads": ["toy.ranks"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root, base


def _tree():
    return {p: p.read_bytes() for p in (ROOT / "amgbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _main(root, base, capfd, trace=0, device="cpu", **kw):
    args = argparse.Namespace(workload="toy.ranks", seed=SEED, seconds=0.5,
                              trace=trace)
    rc = harness.main(args, time.perf_counter(), root, device=device,
                      base=base, **kw)
    out, err = capfd.readouterr()
    assert multiprocessing.active_children() == []
    return rc, out.strip().splitlines(), err


def test_two_ranks_from_added_files_only(tmp_path, capfd):
    root, base = toy_root(tmp_path)
    before = _tree()
    rc, lines, err = _main(root, base, capfd)
    assert rc == 0, err
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"], out["checks"]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 2,
                             "memory_peak_bytes": 0}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "hot_step_ms",
                                   "peak_device_gib"}
    assert list(out["checks"]) == ["residual"]
    assert f"check residual {out['checks']['residual']['value']!r}" in err
    rc, lines, err = _main(root, base, capfd, trace=1)
    assert rc == 0, err
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"] and set(out["metrics"]) == {"toy_steps.toy"}
    assert out["metrics"]["toy_steps.toy"]["value"] == out["attempted"]
    assert _tree() == before


def test_a_wrong_answer_on_one_rank_fails_the_run(tmp_path, capfd):
    """The lead's share is right; rank 1's answers are altered where they
    are made, and the check is the worst over the ranks."""
    root, base = toy_root(tmp_path, plant={"1": "wrong"})
    rc, lines, err = _main(root, base, capfd)
    assert rc == 0, err
    out = json.loads(lines[-1])
    assert not out["correct"]
    assert out["checks"]["residual"]["value"] > \
        out["checks"]["residual"]["limit"]


@pytest.mark.parametrize("plant,said", [
    ("raise", "planted: this rank raised"),
    ("unlisted", "without a limit in limits.json: ['unlisted']")])
def test_a_failing_rank_ends_the_run_without_a_result(tmp_path, capfd,
                                                      plant, said):
    root, base = toy_root(tmp_path, plant={"1": plant})
    rc, lines, err = _main(root, base, capfd)
    assert rc != 0 and lines == []
    assert said in err


def test_a_hanging_rank_is_killed_by_the_watchdog(tmp_path, capfd):
    root, base = toy_root(tmp_path, plant={"1": "hang"})
    watchdog = 20.0
    t0 = time.monotonic()
    rc, lines, err = _main(root, base, capfd, watchdog_s=watchdog)
    assert rc != 0 and lines == []
    assert "within the watchdog's 20 s" in err
    assert time.monotonic() - t0 < watchdog + 10


@pytest.mark.parametrize("precision,fault", [
    (None, None), ("f32", None), (None, "answer_altered"),
    (None, "exchange_left_out")])
def test_control_and_faults_reach_the_ranks(tmp_path, precision, fault):
    """``control.run`` of the 2-rank cell goes through the rank processes:
    sound, it is correct; the f32 control, a rank's answer altered where
    it is made (rank 1 alone) and the exchange between the ranks left
    out each make the merged result not correct."""
    root, base = toy_root(tmp_path)
    out = control.run("toy.ranks", SEED, 0.5, precision=precision,
                      fault=fault, root=root, device="cpu", base=base,
                      watchdog_s=120.0)
    assert multiprocessing.active_children() == []
    assert out["device"]["count"] == 2 and out["failed"] == 0
    assert out["correct"] is (precision is None and fault is None), \
        out["checks"]
    assert set(control.faults("toy_ranks", base)) == {
        "answer_altered", "exchange_left_out"}


def _part(peak, setup_s, failed, worst, busy, window=2.0, complete=True):
    return {"setup_s": setup_s, "peak": peak, "failed": failed,
            "attempted": 7, "worst": worst, "platform": "gpu",
            "kind": "card", "e2e": {"hot_step_ms": 3.0},
            "layers": {"toy_steps.toy": 7.0},
            "trace": {"busy_s": busy, "window_s": window,
                      "complete": complete,
                      "device_ops": [["k", 1.0]], "idle_gaps": []}}


def test_merge_takes_the_worst_rank(tmp_path):
    root, base = toy_root(tmp_path)
    cell = harness.load_cell(root, "toy.ranks", base)
    parts = [_part(5, 10.0, 0, {"residual": 1e-12, "smoother": 3e-13}, 1.0),
             _part(9, 12.0, 2, {"residual": 4e-12, "smoother": math.nan},
                   0.5)]
    out = harness.merge(cell, parts, False, base)
    assert out["device"]["memory_peak_bytes"] == 9
    assert out["device"]["count"] == 2
    assert out["metrics"]["setup_s"]["value"] == 12.0
    assert out["metrics"]["peak_device_gib"]["value"] == 9 / 2 ** 30
    assert out["metrics"]["hot_step_ms"]["value"] == 3.0
    assert out["attempted"] == 7 and out["failed"] == 2
    assert out["checks"]["residual"]["value"] == 4e-12
    assert math.isnan(out["checks"]["smoother"]["value"])
    assert not out["correct"]
    parts.reverse()
    out = harness.merge(cell, parts, True, base)
    assert math.isnan(out["checks"]["smoother"]["value"])
    assert out["device"]["busy_s"] == 0.75
    assert out["device"]["window_s"] == 2.0
    # the busy share is the mean of each rank's own, over its own window,
    # a blind rank's left out; one card reports its reading as it is
    parts = [_part(5, 1.0, 0, {}, 1.0), _part(5, 1.0, 0, {}, 2.0, 8.0),
             _part(5, 1.0, 0, {}, 3.0, 4.0, complete=False)]
    out = harness.merge(cell, parts, True, base)
    assert out["device"]["busy_s"] == 2.0 * (0.5 + 0.25) / 2
    assert out["device"]["window_s"] == 2.0
    out = harness.merge(cell, parts[2:], True, base)
    assert out["device"] == dict(out["device"], busy_s=3.0, window_s=4.0)
    assert out["metrics"] == {"toy_steps.toy": {"value": 7.0,
                                                "unit": "steps"}}
    with pytest.raises(harness.Refused, match="unlisted"):
        harness.merge(cell, [_part(1, 1.0, 0, {"unlisted": 0.0}, 1.0)],
                      False, base)


@pytest.fixture
def two_cards():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_two_ranks_on_two_cards(two_cards, tmp_path, capfd):
    """The toy cell under NCCL, one rank a card, traced: rank 1 holds the
    larger pad, so the fullest card is rank 1's."""
    root, base = toy_root(tmp_path)
    rc, lines, err = _main(root, base, capfd, trace=1, device=None)
    assert rc == 0, err
    out = json.loads(lines[0])
    with capfd.disabled():
        print(lines[0])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert out["device"]["memory_peak_bytes"] >= 2 * 2 ** 20
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    rc, lines, err = _main(root, base, capfd, trace=0, device=None)
    assert rc == 0, err
    out = json.loads(lines[0])
    with capfd.disabled():
        print(lines[0])
    assert out["correct"] and out["device"]["count"] == 2
