"""The port's distributed solve (``repro_torch.dist``) on the CPU against
the single-device ``repro.core.gamg.GAMGSolver``.

``python -m repro_torch.dist.selftest`` runs as a subprocess per world
size — gloo ranks spawned on the CPU, one thread each, at m=7 with the
greedy coarsener and ``coarse_size=12`` (levels ``[882, 108, 60]``, whose
aggregates equal the reference's) — and saves its solutions; the JAX
reference solves the same problem here.  Worlds 1, 2 and 4 (at 4 with
``coarse_eq_limit=0``, so level 1 runs its operator on the all-gather
halo and the coarsest on the replicated Cholesky; the ``--agg`` section
then replicates it).  Checks, each with its tolerance written beside it:
equal iterations and solutions within 1e-10 relative; sharded against
agglomerated equal iterations; overlap on against off bitwise; a k=3
panel's per-column iterations against the reference's batched solve;
the warm start; the halo fault detected on every rank and a clean
re-staging bitwise; the measured messages of one V-cycle against
``dist_cycle_comm``; ``rank0_span`` recording on rank 0 only.  The
8-rank twin at m=6 is ``slow``, as the reference's is.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from torch_helpers import rel_err, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M, COARSE = 7, 12
#: the distributed solution against the reference's, relative to its
#: largest entry (both f64, converged to 1e-8 in equal iterations)
SOL_REL = 1e-10
FULL = ["--mrhs", "--agg", "--overlap", "--fault"]
WORLDS = {1: [], 2: FULL, 4: FULL + ["--coarse-eq-limit", "0"]}


def _start(m: int, world: int, extra, out: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.dist.selftest", str(m),
           "--world", str(world), "--backend", "gloo", "--device", "cpu",
           "--coarse-size", str(COARSE), "--timeout", "300",
           "--out", str(out), *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, out: Path, timeout: float = 240):
    log, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, log[-4000:]
    assert log.rstrip().endswith("OK"), log[-2000:]
    data = np.load(out)
    return json.loads(str(data["result"])), data, log


def _reference(m: int, panel=None):
    """The reference's single-device solves of the selftest's problem: the
    cold solve, the k-column panel and the warm start on 1.5 A."""
    rp = ref_assemble(m, path="host")      # the selftest's assembly path
    solver = ref_gamg.GAMGSolver(rp.A, rp.B, coarse_size=COARSE,
                                 coarsener="greedy", rtol=1e-8, maxiter=200,
                                 precision="f64")
    cold = solver.solve(rp.b)
    out = dict(iters=int(cold.iters), x=to_np(cold.x))
    if panel is not None:
        many = solver.solve_many(jnp.asarray(panel))
        out.update(panel_iters=to_np(many.iters).tolist(),
                   panel_x=to_np(many.x))
    solver.update_operator(rp.A.data * 1.5)
    warm = solver.solve(rp.b, x0=cold.x)
    out.update(warm_iters=int(warm.iters), warm_x=to_np(warm.x))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    procs = {w: _start(M, w, extra, tmp / f"w{w}.npz")
             for w, extra in WORLDS.items()}
    done = {w: _finish(p, tmp / f"w{w}.npz") for w, p in procs.items()}
    panel = done[2][1]["B"]
    return done, _reference(M, panel)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_solve_matches_single_device_reference(runs, world):
    (res, data, _), ref = runs[0][world], runs[1]
    assert res["world"] == world and res["levels"] == [882, 108, 60]
    assert res["iters"] == ref["iters"] == res["iters_single"]
    assert res["status"] == ["healthy"] * world
    assert rel_err(data["x"], ref["x"]) <= SOL_REL
    assert res["repeat_bitwise"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_against_agglomerated(runs, world):
    res = runs[0][world][0]
    agg = res["agg"]
    assert agg["placement"] == ["sharded", "replicated", "replicated"]
    assert agg["iters"] == agg["iters_sharded"] == runs[1]["iters"]
    assert rel_err(runs[0][world][1]["x_agg"], runs[1]["x"]) <= SOL_REL


@pytest.mark.parametrize("world", [2, 4])
def test_overlap_on_against_off_bitwise(runs, world):
    ov = runs[0][world][0]["overlap"]
    assert ov["bitwise"] and ov["iters_on"] == ov["iters_off"]
    assert ov["bnd_rows_max"] > 0     # the split is not trivial


@pytest.mark.parametrize("world", [2, 4])
def test_panel_matches_reference_batched_solve(runs, world):
    (res, data, _), ref = runs[0][world], runs[1]
    assert res["mrhs"]["k"] == 3
    assert res["mrhs"]["iters"] == ref["panel_iters"]
    assert rel_err(data["x_panel"], ref["panel_x"]) <= SOL_REL


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_warm_start_matches_reference(runs, world):
    (res, data, _), ref = runs[0][world], runs[1]
    assert res["warm"]["iters"] == ref["warm_iters"]
    assert rel_err(data["x_warm"], ref["warm_x"]) <= SOL_REL


@pytest.mark.parametrize("world", [2, 4])
def test_halo_fault_detected_then_clean_restaging(runs, world):
    fault = runs[0][world][0]["fault"]
    assert fault["status"] == ["nonfinite"] * world
    assert not fault["converged"] and fault["finite"]
    assert fault["restage_bitwise"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_cycle_messages_match_model(runs, world):
    cyc = runs[0][world][0]["cycle"]
    assert cyc["agree"]
    assert cyc["msgs"] == cyc["model_msgs"]
    assert cyc["bytes"] == cyc["model_bytes"]
    assert (cyc["msgs"] > 0) == (world > 1)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_rank0_span_records_on_rank0_only(runs, world):
    assert runs[0][world][0]["span"] == [1] + [0] * (world - 1)


def test_every_halo_strategy_ran(runs):
    r2, r4 = runs[0][2][0], runs[0][4][0]
    assert r2["halo"] == r4["halo"] == "ppermute"
    assert "allgather" in r4["s2_halo"] and r4["widths"][1] > 1
    assert r4["placement"] == ["sharded", "sharded", "replicated"]
    assert r2["placement"] == ["sharded", "sharded", "replicated"]
    assert runs[0][1][0]["halo"] == "local"


def test_cpu_ranks_count_no_kernel_launch(runs):
    for res, _, _ in runs[0].values():
        assert set(res["launches"].values()) == {0}


@pytest.mark.slow
def test_eight_ranks_at_m6():
    """The 8-rank twin (the reference's slow one) at m=6."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "w8.npz"
        # m=6 coarsens once at coarse_size 12: no mid level to agglomerate
        res, data, _ = _finish(_start(6, 8, ["--mrhs", "--overlap",
                                             "--fault"], out), out,
                               timeout=600)
    ref = _reference(6)
    assert res["iters"] == ref["iters"]
    assert rel_err(data["x"], ref["x"]) <= SOL_REL
    assert res["overlap"]["bitwise"] and res["cycle"]["agree"]
    assert res["fault"]["status"] == ["nonfinite"] * 8
