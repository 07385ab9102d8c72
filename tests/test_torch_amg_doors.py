"""The port's last AMG front doors against the reference's: the torch twins
of ``examples/serve_amg.py``, ``examples/observe_amg.py``,
``examples/heterogeneous.py`` and ``examples/amg_distributed.py``, and of
``python -m repro.dist.measure``, each run on the CPU at m=5 in the
reference example's own setting (device assembly, the MIS coarsener, the
example's ``coarse_size``) beside the reference doing the same.  Levels,
buckets and iterations must be equal; solutions within 1e-10 relative.

The distributed twins run as subprocesses (gloo ranks on the CPU), all
started together with the reference's measure at the first test of the
module, so they overlap with the in-process checks.  The 8-rank m=6
default of ``amg_distributed`` is ``slow``, as the 8-rank dist twin is.
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
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.fem.assemble import inclusion_fields as ref_fields  # noqa: E402
from repro.multirhs import AMGSolveServer as RefServer  # noqa: E402
from repro.obs import describe_tally as ref_describe  # noqa: E402
from repro.obs import use as ref_use  # noqa: E402
from repro.obs.metrics import parse_prometheus as ref_parse  # noqa: E402

from repro_torch import heterogeneous, observe_amg, serve_amg  # noqa: E402

from torch_helpers import rel_err, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M = 5
#: a twin's solution against the reference's, relative to its largest
#: entry (both f64, converged to 1e-8 in equal iterations)
SOL_REL = 1e-10
#: the reference's ``python -m repro.dist.measure 5 2 pc`` (its traced
#: equation counts; the port counts real messages, its power iteration's
#: body once under ``recompute``)
WANT_CYCLE = {"ppermute": 14, "all_gather": 1, "msgs": 15}
WANT_RECOMPUTE = {"ppermute": 6, "all_gather": 1, "msgs": 7}
WANT_HALO_BYTES = {1: 15072, 2: 7536}
WANT_GATHER_BYTES = 336
REF_MEASURE = ("import json\n"
               "from repro.dist import measure\n"
               "for pc in (1, 2):\n"
               "    measure.main(5, 2, pc)\n")
PORT_MEASURE = ("import json\n"
                "from repro_torch.dist import measure\n"
                "print('RESULT ' + json.dumps([measure.main(5, 2, pc, "
                "device='cpu') for pc in (1, 2)]))\n")


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", **extra)


def _start(cmd, **env) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 240) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out[-3000:], err[-4000:])
    return out


@pytest.fixture(scope="module", autouse=True)
def children():
    """The subprocess runs, started once before the module's first test."""
    procs = {
        "ref_measure": _start(
            [sys.executable, "-c", REF_MEASURE],
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            JAX_PLATFORMS="cpu"),
        "port_measure": _start([sys.executable, "-c", PORT_MEASURE]),
        "amg_distributed": _start(
            [sys.executable, "-m", "repro_torch.amg_distributed", "2",
             str(M), "--device", "cpu"]),
    }
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def measured(children):
    ref = [json.loads(ln) for ln in
           _finish(children["ref_measure"]).splitlines()
           if ln.startswith("{")]
    out = _finish(children["port_measure"])
    port = json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])
    return dict(zip((1, 2), zip(port, ref)))


# ---------------------------------------------------------------------------
# serve_amg
# ---------------------------------------------------------------------------

def test_serve_amg_matches_the_reference_server():
    got = serve_amg.main(M, device="cpu")
    prob = ref_assemble(M)
    setupd = ref_gamg.setup(prob.A, prob.B, coarse_size=40)
    server = RefServer(setupd, prob.A.data, buckets=serve_amg.BUCKETS,
                       rtol=1e-8, maxiter=100)
    solve = ref_gamg.make_solve(setupd, rtol=1e-8, maxiter=100)
    hier = ref_gamg.make_recompute(setupd)(prob.A.data)
    assert got["level_rows"] == setupd.stats["level_rows"]
    rng = np.random.default_rng(0)
    for burst, row, xs in zip(serve_amg.BURSTS, got["bursts"],
                              got["solutions"]):
        rhs = [rng.standard_normal(prob.n) for _ in range(burst)]
        want = server.serve(rhs)
        assert row["k_bucket"] == [r.k_bucket for r in want]
        assert row["iters"] == [r.iters for r in want]
        # each request's iterations are its dedicated vector solve's
        assert row["iters"] == [int(solve(hier, b).iters) for b in rhs]
        for x, r in zip(xs, want):
            assert rel_err(x, r.x) <= SOL_REL
    server.update_operator(prob.reassemble(1.2).data)
    want = server.serve([np.asarray(prob.b)] * serve_amg.POST_UPDATE)
    assert got["post_update_iters"] == [r.iters for r in want]
    for x, r in zip(got["solutions"][-1], want):
        assert rel_err(x, r.x) <= SOL_REL
    assert got["stats"] == server.stats


# ---------------------------------------------------------------------------
# observe_amg
# ---------------------------------------------------------------------------

def test_observe_amg_matches_the_reference_telemetry():
    got = observe_amg.main(M, device="cpu")
    prob = ref_assemble(M)
    setupd = ref_gamg.setup(prob.A, prob.B, coarse_size=40)
    with ref_use("counters"):
        solve = ref_gamg.make_solve(setupd, rtol=1e-8, maxiter=100)
    res = solve(ref_gamg.make_recompute(setupd)(prob.A.data), prob.b)
    assert got["level_rows"] == setupd.stats["level_rows"]
    assert got["iters"] == int(res.iters)
    # the analytic count, and the reference's tally field by field
    cycles = got["iters"] + 1
    nl = setupd.n_levels - 1
    t = got["tally"]
    assert (t["level_visits"], t["smoother_applies"], t["coarse_solves"],
            t["precond_applies"]) == ([cycles] * nl, [2 * cycles] * nl,
                                      cycles, cycles)
    assert t == {k: np.asarray(v).tolist()
                 for k, v in res.counters._asdict().items()}
    assert got["tally_line"] == ref_describe(res.counters)
    # the server session: buckets, iterations, history, snapshot, names
    server = RefServer(setupd, prob.A.data, buckets=(1, 2, 4, 8),
                       rtol=1e-8, maxiter=100, record_history=True)
    rng = np.random.default_rng(0)
    bursts = []
    for burst in observe_amg.BURSTS:
        for _ in range(burst):
            server.submit(rng.standard_normal(prob.n))
        bursts.append([[r.k_bucket, r.iters] for r in server.flush()])
    r = server.serve([np.asarray(prob.b)])[0]
    assert got["bursts"] == bursts
    assert (got["request"]["id"], got["request"]["iters"]) == \
        (r.request_id, r.iters)
    live = r.history[np.isfinite(r.history)]
    assert got["request"]["history_len"] == len(live)
    np.testing.assert_allclose(got["history"][:len(live)], live, rtol=1e-8)
    snap = server.snapshot()
    assert set(got["snapshot"]) <= set(snap)
    for key in ("requests", "batches", "padded_columns",
                "padding_efficiency", "solves_per_k", "status"):
        assert got["snapshot"][key] == snap[key], key
    assert got["prometheus"] == sorted(ref_parse(
        server.metrics().to_prometheus()))
    assert got["recompute"]["compile"]["count"] == 1
    assert got["recompute"]["steady"]["count"] == 2


# ---------------------------------------------------------------------------
# heterogeneous
# ---------------------------------------------------------------------------

def test_heterogeneous_matches_the_reference_ramp():
    got = heterogeneous.main(M, device="cpu")
    prob = ref_assemble(M)
    solver = ref_gamg.GAMGSolver(prob.A, prob.B, coarse_size=40,
                                 rtol=1e-8, maxiter=100)
    solver.bind_assembler(prob.assembler)
    assert got["level_rows"] == solver.setup_data.stats["level_rows"]
    iters = []
    for contrast, x in zip(heterogeneous.CONTRASTS, got["solutions"]):
        solver.update_coefficients(*ref_fields(prob.mesh,
                                               E_inclusion=contrast))
        res = solver.solve(prob.b)
        iters.append(int(res.iters))
        assert rel_err(x, to_np(res.x)) <= SOL_REL
    assert got["iters"] == iters == [8, 10, 14, 17]
    # the two per-element fields are the update's whole payload; on the
    # CPU nothing crosses to a device
    ne = prob.mesh.n_elements
    assert got["n_elements"] == ne and got["field_bytes"] == 2 * ne * 8
    assert [s["h2d_bytes"] for s in got["steps"]] == [0] * 4


# ---------------------------------------------------------------------------
# dist.measure and amg_distributed (subprocesses)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pc", [1, 2])
def test_dist_measure_matches_the_reference(measured, pc):
    port, ref = measured[pc]
    assert (port["m"], port["pr"], port["pc"]) == (ref["m"], ref["pr"],
                                                   ref["pc"]) == (5, 2, pc)
    for key in ("cycle", "recompute"):
        want = WANT_CYCLE if key == "cycle" else WANT_RECOMPUTE
        assert ref["measured"][key] == want
        assert {k: port["measured"][key][k] for k in want} == want
    assert port["model_msgs"] == ref["model_msgs"] == 15
    assert port["model_rows"] == ref["model_rows"]
    assert port["model_rows"][0]["halo_bytes"] == WANT_HALO_BYTES[pc]
    assert port["model_rows"][1]["gather_bytes"] == WANT_GATHER_BYTES
    # the bytes agree only on a 1-D mesh: the model splits a slab's halo
    # bytes pc ways, a rank counts whole slabs
    assert port["agree"]
    assert (port["measured"]["cycle"]["bytes"] == port["model_bytes"]) \
        == (pc == 1)
    assert port["measured"]["recompute_calls"]["msgs"] > \
        port["measured"]["recompute"]["msgs"]


def _dist_result(out: str) -> dict:
    lines = out.splitlines()
    assert lines[-1] == "OK", out[-3000:]
    return json.loads(next(ln for ln in lines if ln.startswith(
        "dist result "))[len("dist result "):])


def _ref_single(m: int):
    prob = ref_assemble(m)
    solver = ref_gamg.GAMGSolver(prob.A, prob.B, coarse_size=30, rtol=1e-8,
                                 maxiter=200, precision="f64")
    return solver.setup_data.stats["level_rows"], int(solver.solve(
        prob.b).iters)


def test_amg_distributed_matches_the_reference_single_device(children):
    res = _dist_result(_finish(children["amg_distributed"]))
    levels, iters = _ref_single(M)
    assert (res["world"], res["backend"], res["device"]) == (2, "gloo",
                                                             "cpu")
    assert res["levels"] == levels
    assert res["iters"] == res["iters_single"] == iters
    assert res["status"] == ["healthy"] * 2 and res["cycle"]["agree"]


@pytest.mark.slow
def test_amg_distributed_default_eight_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.amg_distributed", "8", "6",
         "--device", "cpu"], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = _dist_result(out.stdout)
    levels, iters = _ref_single(6)
    assert res["world"] == 8 and res["levels"] == levels
    assert res["iters"] == res["iters_single"] == iters


def test_amg_distributed_maps_the_reference_switches(monkeypatch):
    from repro_torch import amg_distributed
    for var in amg_distributed.SECTIONS:
        monkeypatch.delenv(var, raising=False)
    base = amg_distributed.command(2, 5, device="cpu")
    assert base[2:] == ["repro_torch.dist.selftest", "5", "--world", "2",
                        "--backend", "gloo", "--device", "cpu",
                        "--coarsener", "mis", "--coarse-size", "30"]
    monkeypatch.setenv("REPRO_SELFTEST_MRHS", "1")
    monkeypatch.setenv("REPRO_SELFTEST_FAULT", "1")
    monkeypatch.setenv("REPRO_SELFTEST_AGG", "0")
    assert amg_distributed.command(2, 5, device="cpu")[len(base):] == \
        ["--mrhs", "--fault"]
