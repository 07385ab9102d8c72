"""The judging separates sound runs from the control and from each fault
a cell can have: every cell run at a small size on the CPU, through the
whole of a run but the look for a card, must come out correct as it
is, and not correct with the program's f32 path switched on or with its
timed path broken underneath."""
import pytest

from amgbench_cells import ROOT, small_root
from amgbench import control, harness

CELLS = {name: harness.load_cell(ROOT, name).traffic["generator"]
         for name in (w["name"] for w in __import__("json").loads(
             (ROOT / "BENCHMARK.json").read_text())["workloads"])}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = control.run(cell, 2147483659, 0.5, root=root, device="cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    out = control.run(cell, 11, 0.5, precision="f32", root=root,
                      device="cpu")
    assert not out["correct"], out["checks"]
    # the solve still converges in f64: only the operator layers tell it
    assert out["checks"]["residual"]["value"] <= \
        out["checks"]["residual"]["limit"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, kind in CELLS.items() for f in control.FAULTS[kind]])
def test_fault_is_not_correct(root, cell, fault):
    out = control.run(cell, 12, 0.5, fault=fault, root=root, device="cpu")
    assert not out["correct"], out["checks"]
