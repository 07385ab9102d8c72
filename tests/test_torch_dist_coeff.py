"""The port's distributed coefficient program (``repro_torch.dist.solver
.build_dist_assembly``, ``_rank_assemble``, ``make_dist_coeff_solver``)
against ``repro.dist.solver``'s and the single-device ``repro`` solves on
the CPU.

Staging: the reference's m=5 setup (its defaults, ``coarse_size=12``)
carried across to the port through numpy, sharded placement
(``coarse_eq_limit=0``) at 1, 2 and 4 ranks, the reference's
``DeviceAssembler`` beside the port's on the same COO plan: every array
of ``DistAssembly`` bitwise, the scatter of an f32 caller's fields at the
policy dtype bitwise.  Rank assembly: each rank's slab on
``inclusion_fields`` within ``RANK_REL`` of the reference's
``_rank_assemble`` (the two quadratures round differently: 6e-16
measured at m=5) and bitwise the port's global assembly through
``scatter_fine_payloads``.

Solves: ``python -m repro_torch.dist.selftest 7 --coeff --march --mrhs``
spawned once per world (2 with the replicated tail, 4 fully sharded)
against ``repro``'s ``GAMGSolver.update_coefficients`` -> ``solve`` /
``solve_many`` on the inclusion fields and ``gamg.make_coeff_solve`` on
the same 3-step softening march: equal iterations (per column, per
step), solutions within ``SOL_REL``, the coefficient program's x slabs
bitwise the value-stream program's, the warm last step no more
iterations than a cold one, the rank operands staged once.
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
from repro.dist import solver as ref_solver  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.fem.assemble import inclusion_fields as ref_inclusion  # noqa
from repro.fem.device_stiffness import DeviceAssembler as RefAssembler  # noqa

from repro_torch.dist import solver  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.fem.assemble import inclusion_fields  # noqa: E402
from repro_torch.interop import setup_from_numpy  # noqa: E402

from torch_helpers import rel_err, setup_to_numpy, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M, COARSE = 7, 12
RANKS = [1, 2, 4]
#: a rank's assembled slab against the reference's, relative to its
#: largest entry (XLA's and torch's quadrature products round apart)
RANK_REL = 1e-13
#: a distributed solution against the reference's (both f64, converged
#: to 1e-8 in equal iterations)
SOL_REL = 1e-10
WORLDS = {2: ["--mrhs", "--fault"],
          4: ["--mrhs", "--coarse-eq-limit", "0"]}
FIELDS = ("elem_ids", "contrib_elem", "contrib_pa", "contrib_pb",
          "contrib_seg", "contrib_mask", "quad_b", "quad_w")


@pytest.fixture(scope="module")
def staged():
    """The reference's m=5 problem, setup and staging inputs beside the
    port's: (ref problem, ref setup, port setup, port problem)."""
    rp = ref_assemble(5)
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=12, precision="f64")
    levels, coarse = setup_to_numpy(ref)
    port = setup_from_numpy(levels, coarse, precision="f64",
                            coarsener=ref.coarsener, device="cpu")
    prob = assemble_elasticity(5, device="cpu")
    return rp, ref, port, prob


def _both(staged, ndev):
    rp, ref, port, prob = staged
    dgr = ref_solver.build_dist_gamg(ref, ndev, coarse_eq_limit=0)
    dgp = solver.build_dist_gamg(port, ndev, coarse_eq_limit=0)
    return (dgr, ref_solver.build_dist_assembly(dgr, rp.assembler),
            dgp, solver.build_dist_assembly(dgp, prob.assembler))


@pytest.mark.parametrize("ndev", RANKS)
def test_assembly_staging_bitwise(staged, ndev):
    _, dar, _, dap = _both(staged, ndev)
    for f in FIELDS:
        want, got = np.asarray(getattr(dar, f)), getattr(dap, f)
        assert (want.dtype, want.shape) == (got.dtype, got.shape), f
        assert want.tobytes() == got.tobytes(), f
    for f in ("nn", "bs", "a_pad", "n_elements", "ndev"):
        assert getattr(dar, f) == getattr(dap, f), f
    assert dap.stage_dtype == torch.float64 == torch.from_numpy(
        np.zeros(1, dar.stage_dtype)).dtype
    # the m=5 numbers at 2 ranks (the reference's, checked on a copy)
    if ndev == 2:
        assert dap.elem_ids.shape == (2, 48)
        assert dap.contrib_seg.shape == (2, 1792)
        assert dap.a_pad == 846 and int(dap.contrib_mask.sum()) == 3328


def test_assembly_staging_rejects_a_foreign_plan(staged):
    """An assembler whose plan is not the staged fine level's raises, with
    the reference's message."""
    _, ref, port, _ = staged
    other = assemble_elasticity(4, device="cpu")
    dgp = solver.build_dist_gamg(port, 2, coarse_eq_limit=0)
    with pytest.raises(ValueError, match="assembler plan does not match"):
        solver.build_dist_assembly(dgp, other.assembler)
    dgr = ref_solver.build_dist_gamg(ref, 2, coarse_eq_limit=0)
    with pytest.raises(ValueError, match="assembler plan does not match"):
        ref_solver.build_dist_assembly(dgr, ref_assemble(4).assembler)


@pytest.mark.parametrize("ndev", RANKS)
def test_rank_assembly_against_reference_and_global(staged, ndev):
    """Each rank's slab: within ``RANK_REL`` of the reference's rank body,
    bitwise the port's global assembly scattered to the rank; the
    kernel's offsets leave every slot past the rank's count empty."""
    rp, _, _, prob = staged
    dgr, dar, dgp, dap = _both(staged, ndev)
    E, nu = inclusion_fields(prob.mesh)
    assert all(np.array_equal(a, b) for a, b in
               zip((E, nu), ref_inclusion(rp.mesh)))
    Er, nur = dar.scatter_fields(E, nu)
    sharded = dar.sharded_args()
    glob = dgp.scatter_fine_payloads(prob.coefficient_operator(E, nu).data)
    for r in range(ndev):
        aargs = dap.rank_args(r, "cpu")
        Ep, nup = dap.scatter_fields(E, nu, r)
        slab = solver._rank_assemble(dap, aargs, Ep, nup)
        want = to_np(ref_solver._rank_assemble(
            dar, {k: v[r] for k, v in sharded.items()}, Er[r], nur[r]))
        assert slab.dtype == torch.float64 and slab.shape == want.shape
        assert rel_err(slab.numpy(), want) <= RANK_REL
        assert torch.equal(slab, glob[r])
        count = int(dap.contrib_mask[r].sum())
        offs = aargs["offsets"].numpy()
        assert aargs["perm"].dtype == aargs["offsets"].dtype == torch.int32
        assert offs.shape == (dap.a_pad + 1,) and offs[-1] == count
        nslots = int(dgp.levels[0].a_nnz_starts[r + 1]
                     - dgp.levels[0].a_nnz_starts[r])
        assert (offs[nslots:] == count).all() and not slab[nslots:].any()
    assert dap.n_staged == ndev
    dap.rank_args(0, "cpu")
    assert dap.n_staged == ndev          # staged once per rank


def test_scatter_fields_stage_at_the_policy_dtype(staged):
    """An f32 caller's fields stage at f64, bitwise the reference's
    scatter; per-rank slabs are the stack's rows, host tensors and arrays
    stage alike, and scalars broadcast."""
    rp, _, _, prob = staged
    _, dar, _, dap = _both(staged, 2)
    E, nu = inclusion_fields(prob.mesh)
    E32 = np.asarray(E, np.float32) * np.float32(1.5)
    want_E, want_nu = (to_np(t) for t in dar.scatter_fields(E32, nu))
    got_E, got_nu = dap.scatter_fields(E32, nu)
    for want, got in ((want_E, got_E), (want_nu, got_nu)):
        assert got.dtype == torch.float64 and want.dtype == np.float64
        assert got.numpy().tobytes() == want.tobytes()
    for r in range(2):
        e_r, nu_r = dap.scatter_fields(torch.as_tensor(E32), nu, r)
        assert torch.equal(e_r, got_E[r]) and torch.equal(nu_r, got_nu[r])
    e_s, _ = dap.scatter_fields(2.0, 0.3)
    assert e_s.shape == dap.elem_ids.shape and bool((e_s == 2.0).all())
    assert to_np(dar.scatter_fields(2.0, 0.3)[0]).tobytes() == \
        e_s.numpy().tobytes()


# ---------------------------------------------------------------------------
# The spawned coefficient program against repro's single-device solves
# ---------------------------------------------------------------------------

def _start(world: int, extra, out: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.dist.selftest", str(M),
           "--world", str(world), "--backend", "gloo", "--device", "cpu",
           "--coarse-size", str(COARSE), "--timeout", "300", "--coeff",
           "--march", "--out", str(out), *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, out: Path):
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    assert log.rstrip().endswith("OK"), log[-2000:]
    data = np.load(out)
    return json.loads(str(data["result"])), data


def _panel(b: np.ndarray) -> np.ndarray:
    """The selftest's k=3 panel (``dist.selftest._panel``)."""
    rng = np.random.default_rng(0)
    return np.stack([b, 0.5 * b + rng.standard_normal(b.shape[0]),
                     rng.standard_normal(b.shape[0])], axis=1)


def _reference() -> dict:
    """``repro``'s single-device solves of the selftest's problem: the
    inclusion fields through ``update_coefficients`` -> ``solve`` and
    ``solve_many``, then the 3-step softening march through
    ``make_coeff_solve`` (warm, and the last step cold)."""
    from repro.sim.scenarios import SofteningScenario
    rp = ref_assemble(M, path="host")      # the selftest's assembly path
    slv = ref_gamg.GAMGSolver(rp.A, rp.B, coarse_size=COARSE,
                              coarsener="greedy", rtol=1e-8, maxiter=200,
                              precision="f64")
    asm = RefAssembler.build(rp.mesh, rp.coo_plan)
    slv.bind_assembler(asm)
    slv.update_coefficients(*ref_inclusion(rp.mesh))
    coeff = slv.solve(rp.b)
    panel = _panel(to_np(rp.b))
    many = slv.solve_many(jnp.asarray(panel))
    out = dict(iters=int(coeff.iters), x=to_np(coeff.x), panel=panel,
               panel_iters=to_np(many.iters).tolist(),
               panel_x=to_np(many.x))
    step = ref_gamg.make_coeff_solve(slv.setup_data, asm, rtol=1e-8,
                                     maxiter=200)
    scen = SofteningScenario.build(rp, rate=0.3)
    state, x = scen.init_state(), jnp.zeros_like(rp.b)
    iters, xs = [], []
    for s in range(3):
        E, nu, state = scen.step_fields(state, x, jnp.asarray(s, jnp.int32))
        res = step(E, nu, rp.b, x)
        iters.append(int(res.iters))
        xs.append(to_np(res.x))
        x = res.x
    cold = step(E, nu, rp.b, jnp.zeros_like(rp.b))
    out.update(march_iters=iters, march_x=xs, cold_iters=int(cold.iters))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_coeff")
    procs = {w: _start(w, extra, tmp / f"w{w}.npz")
             for w, extra in WORLDS.items()}
    ref = _reference()                 # while the ranks run
    done = {w: _finish(p, tmp / f"w{w}.npz") for w, p in procs.items()}
    for res, data in done.values():
        assert np.array_equal(data["B"], ref["panel"])
    return done, ref


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_coefficient_program_matches_reference(runs, world):
    (res, data), ref = runs[0][world], runs[1]
    c = res["coeff"]
    assert res["levels"] == [882, 108, 60]
    assert c["iters"] == c["iters_single"] == ref["iters"]
    assert c["status"] == ["healthy"] * world
    assert rel_err(data["x_coeff"], ref["x"]) <= SOL_REL
    # every element reaches some rank; the m=7 grid has (m-1)^3 elements
    assert c["epad"] * world >= (M - 1) ** 3 >= c["epad"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_coefficient_slabs_bitwise_value_stream(runs, world):
    """Rank assembly == the global assembly's slabs, bit for bit, so the
    coefficient program's x slabs are the value-stream program's."""
    c = runs[0][world][0]["coeff"]
    assert c["slab_bitwise"] and c["slab_rel"] == 0.0
    assert c["x_bitwise"] and c["iters_value"] == c["iters"]
    assert c["assemble_launches"] == 0       # CPU ranks: the plain version


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_coefficient_panel_matches_reference(runs, world):
    (res, data), ref = runs[0][world], runs[1]
    m = res["coeff"]["mrhs"]
    assert m["k"] == 3
    assert m["iters"] == m["iters_single"] == m["iters_vector"] \
        == ref["panel_iters"]
    assert rel_err(data["x_coeff_panel"], ref["panel_x"]) <= SOL_REL


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_f32_update_stages_at_policy_dtype_once(runs, world):
    f32 = runs[0][world][0]["coeff"]["f32_update"]
    assert f32["dtype"] == "float64" and f32["restaged"] == 0
    assert f32["h2d_bytes"] == 0             # nothing is on a card here


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_warm_march_matches_reference(runs, world):
    (res, data), ref = runs[0][world], runs[1]
    mr = res["march"]
    assert mr["iters"] == mr["iters_single"] == ref["march_iters"]
    for s in range(3):
        assert rel_err(data[f"x_march{s}"], ref["march_x"][s]) <= SOL_REL
    assert mr["iters"][-1] <= mr["iters_cold_last"] == ref["cold_iters"]
    assert mr["staged"] == [1] * world
    assert all(r["status"] == ["healthy"] * world for r in mr["steps"])


def test_coefficient_program_flags_a_halo_fault(runs):
    """The ``halo`` fault site is live on the coefficient program: world
    2's ``halo:nan`` schedule is flagged on both ranks."""
    fault = runs[0][2][0]["coeff"]["fault"]
    assert fault["status"] == ["nonfinite"] * 2
    assert not fault["converged"] and fault["finite"]


class _SoloComm:
    """World 1 in one process: every collective is the rank's own value
    (a world-1 halo is ``local`` and exchanges nothing)."""

    rank, world = 0, 1

    def allreduce_sum(self, x):
        return x

    def all_gather_tiled(self, x):
        return x


def test_coefficient_program_in_process(staged):
    """World 1 without a process group: the coefficient program bitwise
    the value-stream program on the global assembly and at
    ``make_coeff_solve``'s iterations; the ``spmv`` fault site is live;
    with spans on at build time one call lands in
    ``dist/coeff_solve/seconds``."""
    from repro_torch.core import gamg
    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.robust import inject
    from repro_torch.robust.health import HEALTHY, NONFINITE
    prob = staged[3]
    sd = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy",
                    precision="f64")
    dg = solver.build_dist_gamg(sd, 1, coarse_eq_limit=0)
    da = solver.build_dist_assembly(dg, prob.assembler)
    args, aargs = dg.rank_args(0, "cpu"), da.rank_args(0, "cpu")
    E, nu = inclusion_fields(prob.mesh)
    fields = da.scatter_fields(E, nu, 0)
    b = dg.scatter_vector(prob.b, 0)
    comm = _SoloComm()
    x, it, _, ok, st = solver.make_dist_coeff_solver(dg, da, comm)(
        args, aargs, *fields, b)
    a0 = dg.scatter_fine_payloads(prob.coefficient_operator(E, nu).data, 0)
    xv, itv = solver.make_dist_solver(dg, sd, comm)(args, a0, b)[:2]
    ref = gamg.make_coeff_solve(sd, prob.assembler)(
        *prob.assembler.as_fields(E, nu), prob.b, torch.zeros_like(prob.b))
    assert bool(ok) and int(st) == HEALTHY
    assert it == itv == ref.iters and torch.equal(x, xv)
    assert rel_err(dg.gather_vector(x[None]).numpy(),
                   ref.x.numpy()) <= SOL_REL
    with inject.active(inject.parse_schedule("spmv:nan@1")):
        faulted = solver.make_dist_coeff_solver(dg, da, comm)
        _, _, _, okf, stf = faulted(args, aargs, *fields, b)
    assert not bool(okf) and int(stf) == NONFINITE
    metrics.reset_default_registry()
    with obs_trace.use("spans"):
        timed = solver.make_dist_coeff_solver(dg, da, comm, warm_start=True)
        timed(args, aargs, *fields, b, x)
    hist = metrics.default_registry().get("dist/coeff_solve/seconds")
    assert hist is not None and hist.snapshot()["count"] == 1
