"""The port's time march (``repro_torch.sim``) against ``repro.sim`` (JAX on
the CPU) at m=4 with the reference's setting (device assembly, the MIS
coarsener, ``coarse_size=8``, softening rate 0.3): the staleness monitor,
both scenarios' laws, the step loop and the frozen scan against the
reference's eager loop and unrolled scan, the adaptive and frozen marches,
the front door, validation, and the march-level fault battery.  Integer
and boolean records must match bitwise; ``x``, ``relres`` and
``coeff_drift`` within 1e-12 relative (the port reorders sums)."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro import sim as rsim  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.robust import inject as rinject  # noqa: E402
from repro.sim.driver import _setup_from_fields as ref_setup_from_fields

from repro_torch import sim  # noqa: E402
from repro_torch.core import gamg  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.robust import health, inject  # noqa: E402
from repro_torch.sim.driver import _setup_from_fields  # noqa: E402

from torch_helpers import rel_err, to_np  # noqa: E402

SETUP_OPTS = {"coarse_size": 8}
REL = 1e-12
DRIFT = 1e-14
INT_FIELDS = ("iters", "status", "tripped")
FLOAT_FIELDS = ("relres", "coeff_drift")


def _frozen_cfg(mod, n_steps=3):
    """A monitor that never trips: the pure frozen-hierarchy march (the
    reference's ``tests/test_march.py`` setting)."""
    return mod.MarchConfig(
        n_steps=n_steps, seg_len=8, rtol=1e-9,
        staleness=mod.StalenessConfig(iter_drift=10**6, ref_window=1,
                                      coeff_rtol=10**6))


def _quick_cfg(mod):
    return mod.MarchConfig(n_steps=3, seg_len=8, rtol=1e-8)


@pytest.fixture(scope="module")
def port():
    prob = assemble_elasticity(4, device="cpu")
    return prob, sim.SofteningScenario.build(prob, rate=0.3, d_max=0.99)


@pytest.fixture(scope="module")
def ref():
    prob = ref_assemble(4)
    return prob, rsim.SofteningScenario.build(prob, rate=0.3, d_max=0.99)


@pytest.fixture(scope="module")
def ref_marches(ref):
    """The reference's adaptive and frozen marches, run once."""
    prob, scen = ref
    return {
        "adaptive": rsim.march(prob, scen, _quick_cfg(rsim),
                               mode="adaptive", setup_opts=SETUP_OPTS),
        "frozen": rsim.march(prob, scen, _frozen_cfg(rsim), mode="frozen",
                             setup_opts=SETUP_OPTS)}


def _step0_setup(mod, setup_from_fields, prob, scen):
    carry = mod.init_carry(scen, prob.b)
    E, nu, _ = scen.step_fields(carry.scen, carry.x, carry.step)
    return setup_from_fields(prob, E, nu, SETUP_OPTS)


# ---------------------------------------------------------------------------
# The staleness monitor and the laws
# ---------------------------------------------------------------------------

@given(ne=st.integers(4, 48), seed=st.integers(0, 2**31 - 1),
       n_steps=st.integers(1, 12), iter_drift=st.integers(0, 6),
       ref_window=st.integers(0, 4), coeff_rtol=st.floats(0.01, 0.6),
       rate=st.floats(0.0, 0.2))
@settings(max_examples=25, deadline=None)
def test_staleness_update_matches_reference(ne, seed, n_steps, iter_drift,
                                            ref_window, coeff_rtol, rate):
    rng = np.random.default_rng(seed)
    E = 1.0 + rng.random(ne)
    iters = rng.integers(1, 30, n_steps)
    soft = 1.0 - rate * rng.random((n_steps, ne))
    cfg = sim.StalenessConfig(iter_drift, ref_window, coeff_rtol)
    rcfg = rsim.StalenessConfig(iter_drift, ref_window, coeff_rtol)
    st_p = sim.staleness_init(torch.from_numpy(E.copy()))
    st_r = rsim.staleness_init(jnp.asarray(E))
    for k in range(n_steps):
        E = E * soft[k]
        st_p = sim.staleness_update(
            st_p, torch.tensor(int(iters[k]), dtype=torch.int32),
            torch.from_numpy(E.copy()), cfg)
        st_r = rsim.staleness_update(st_r, jnp.asarray(iters[k], jnp.int32),
                                     jnp.asarray(E), rcfg)
        for f in ("ref_iters", "steps_since", "tripped", "iter_excess"):
            assert to_np(getattr(st_p, f)).item() == \
                np.asarray(getattr(st_r, f)).item(), f
        assert st_p.ref_iters.dtype == torch.int32
        got, want = float(st_p.coeff_drift), float(st_r.coeff_drift)
        assert abs(got - want) <= DRIFT * max(1.0, abs(want))


def test_staleness_init_is_the_references():
    e = np.linspace(1.0, 2.0, 7)
    p, r = sim.staleness_init(torch.from_numpy(e)), \
        rsim.staleness_init(jnp.asarray(e))
    for f in p._fields:
        assert to_np(getattr(p, f)).tolist() == \
            np.asarray(getattr(r, f)).tolist(), f
    assert int(p.ref_iters) == np.iinfo(np.int32).max


@pytest.mark.parametrize("seed", range(3))
def test_softening_step_fields_match_reference(port, ref, seed):
    (prob, scen), (rprob, rscen) = port, ref
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(prob.n) * 0.1
    dmg = rng.random(prob.mesh.n_elements) * 0.5
    E, nu, d2 = scen.step_fields(torch.from_numpy(dmg.copy()),
                                 torch.from_numpy(x.copy()),
                                 torch.tensor(seed, dtype=torch.int32))
    rE, rnu, rd2 = rscen.step_fields(jnp.asarray(dmg), jnp.asarray(x),
                                     jnp.asarray(seed, jnp.int32))
    for got, want in ((E, rE), (nu, rnu), (d2, rd2)):
        assert rel_err(got, want) <= DRIFT
    assert to_np(scen.init_state()).tolist() == \
        np.asarray(rscen.init_state()).tolist()


def test_thermal_step_fields_match_reference(port, ref):
    (prob, _), (rprob, _) = port, ref
    scen = sim.ThermalScenario.build(prob, amp=0.2, period=8.0)
    rscen = rsim.ThermalScenario.build(rprob, amp=0.2, period=8.0)
    x = torch.zeros_like(prob.b)
    assert scen.init_state() == ()
    for s in range(10):
        E, nu, state = scen.step_fields((), x, torch.tensor(
            s, dtype=torch.int32))
        rE, rnu, _ = rscen.step_fields((), jnp.zeros_like(rprob.b),
                                       jnp.asarray(s, jnp.int32))
        assert rel_err(E, rE) <= DRIFT and rel_err(nu, rnu) == 0.0
        assert state == ()


def test_thermal_cycle_stays_below_tolerance(port):
    """The counter-workload: a modulation bounded below the drift
    tolerance cycles without a trip."""
    prob = port[0]
    scen = sim.ThermalScenario.build(prob, amp=0.2, period=8.0)
    cfg = sim.StalenessConfig(iter_drift=10**6, ref_window=1, coeff_rtol=0.5)
    x = torch.zeros_like(prob.b)
    step = torch.zeros((), dtype=torch.int32)
    E_ref, _, _ = scen.step_fields((), x, step)
    state = sim.staleness_init(E_ref)
    for s in range(1, 17):
        E, _, _ = scen.step_fields((), x, step + s)
        state = sim.staleness_update(state, torch.tensor(7), E, cfg)
        assert not bool(state.tripped), (s, float(state.coeff_drift))


# ---------------------------------------------------------------------------
# The step loop and the frozen scan against the reference's
# ---------------------------------------------------------------------------

def _check_records(got: dict, want: dict) -> None:
    for f in INT_FIELDS:
        assert got[f] == want[f], (f, got[f], want[f])
    for f in FLOAT_FIELDS:
        assert rel_err(np.asarray(got[f]), np.asarray(want[f])) <= REL, f


def _stacked(recs) -> dict:
    return {f: to_np(getattr(recs, f)).tolist() for f in recs._fields}


def test_step_loop_and_scan_match_references_eager_runs(port, ref):
    (prob, scen), (rprob, rscen) = port, ref
    sd = _step0_setup(sim, _setup_from_fields, prob, scen)
    rsd = _step0_setup(rsim, ref_setup_from_fields, rprob, rscen)
    assert sd.stats["level_rows"] == list(rsd.stats["level_rows"])
    cfg, rcfg = _frozen_cfg(sim), _frozen_cfg(rsim)

    step_fn = sim.make_step_fn(sd, prob.assembler, scen, cfg)
    rstep_fn = rsim.make_step_fn(rsd, rprob.assembler, rscen, rcfg)
    c, rc = sim.init_carry(scen, prob.b), rsim.init_carry(rscen, rprob.b)
    recs, rrecs = [], []
    for _ in range(cfg.n_steps):
        c, rec, blocked = step_fn(c, prob.b)
        rc, rrec, rblocked = rstep_fn(rc, rprob.b)
        assert not bool(blocked) and not bool(rblocked)
        recs.append(rec)
        rrecs.append(rrec)
    as_dict = (lambda rs: {f: [to_np(getattr(r, f)).item() for r in rs]
                           for f in rs[0]._fields})
    _check_records(as_dict(recs), as_dict(rrecs))
    assert int(c.step) == int(rc.step) == cfg.n_steps
    assert rel_err(c.x, rc.x) <= REL
    assert rel_err(c.scen, rc.scen) <= REL

    runner = sim.make_scan_march(sd, prob.assembler, scen, cfg)
    c_scan, recs_scan = runner(prob.b, sim.init_carry(scen, prob.b))
    rrunner = rsim.make_scan_march(rsd, rprob.assembler, rscen, rcfg,
                                   unroll=True)
    rc_scan, rrecs_scan = rrunner(rprob.b, rsim.init_carry(rscen, rprob.b))
    _check_records(_stacked(recs_scan), _stacked(rrecs_scan))
    assert rel_err(c_scan.x, rc_scan.x) <= REL
    # one eager program: the scan is the step loop, bit for bit
    assert torch.equal(c_scan.x, c.x) and torch.equal(c_scan.scen, c.scen)
    assert _stacked(recs_scan) == as_dict(recs)


def test_segment_exit_and_buffers(port):
    """The segment stops at the budget and leaves its unused slots at the
    reference's fill (-1, NaN, False)."""
    prob, scen = port
    sd = _step0_setup(sim, _setup_from_fields, prob, scen)
    cfg = _frozen_cfg(sim)
    seg = sim.make_segment(sd, prob.assembler, scen, cfg)
    k, c, recs, blocked = seg(prob.b, sim.init_carry(scen, prob.b), 2)
    assert k == 2 and int(c.step) == 2 and not bool(blocked)
    assert recs.iters[2:].tolist() == [-1] * (cfg.seg_len - 2)
    assert torch.isnan(recs.relres[2:]).all()
    assert recs.status[:2].tolist() == [health.HEALTHY] * 2
    assert recs.iters.dtype == torch.int32 and recs.tripped.dtype == \
        torch.bool


# ---------------------------------------------------------------------------
# The driver against the reference's
# ---------------------------------------------------------------------------

def _check_march(res, want):
    assert res.status == want.status
    assert res.steps_done == want.steps_done
    assert res.n_setups == want.n_setups
    assert res.n_recoveries == want.n_recoveries
    assert res.iters.tolist() == want.iters.tolist()
    assert res.step_status.tolist() == want.step_status.tolist()
    assert res.tripped.tolist() == want.tripped.tolist()
    assert [vars(s) for s in res.segments] == [vars(s) for s in want.segments]
    assert [a["status"] for a in res.attempts] == \
        [a["status"] for a in want.attempts]
    assert res.worst_status == want.worst_status
    if res.steps_done:
        assert rel_err(res.relres, want.relres) <= REL
        assert rel_err(res.coeff_drift, want.coeff_drift) <= REL
    assert rel_err(res.x, want.x) <= REL
    assert bool(torch.isfinite(res.x).all())


@pytest.mark.parametrize("mode", ["adaptive", "frozen"])
def test_march_matches_reference(port, ref_marches, mode):
    prob, scen = port
    cfg = _quick_cfg(sim) if mode == "adaptive" else _frozen_cfg(sim)
    res = sim.march(prob, scen, cfg, mode=mode, setup_opts=SETUP_OPTS)
    want = ref_marches[mode]
    _check_march(res, want)
    assert res.status == "ok" and res.steps_done == 3
    assert (res.relres <= cfg.rtol).all()
    assert float(res.scen_state.max()) > 0
    assert float(res.E.min()) < float(scen.E0.min())


def test_march_mode_and_path_validation(port):
    prob, scen = port
    cfg = sim.MarchConfig(n_steps=1)
    with pytest.raises(ValueError, match="invalid march mode"):
        sim.march(prob, scen, cfg, mode="bogus", setup_opts=SETUP_OPTS)
    host = assemble_elasticity(4, path="host", device="cpu")
    with pytest.raises(ValueError, match="device assembly path"):
        sim.march(host, scen, cfg, setup_opts=SETUP_OPTS)


def test_gamg_solver_march_front_door(port, ref):
    (prob, scen), (rprob, rscen) = port, ref
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=8, maxiter=200)
    res = solver.march(prob, scen, sim.MarchConfig(n_steps=2, seg_len=4),
                       mode="frozen", setup_opts=SETUP_OPTS)
    rsolver = ref_gamg.GAMGSolver(rprob.A, rprob.B, coarse_size=8,
                                  maxiter=200, precision="f64")
    want = rsolver.march(rprob, rscen, rsim.MarchConfig(n_steps=2,
                                                        seg_len=4),
                         mode="frozen", setup_opts=SETUP_OPTS)
    assert res.status == "ok" and res.steps_done == 2
    _check_march(res, want)


# ---------------------------------------------------------------------------
# The march-level fault battery (tests/test_fault_battery.py's march cases)
# ---------------------------------------------------------------------------

def _faulted(port, ref, spec, mode):
    (prob, scen), (rprob, rscen) = port, ref
    with inject.active(inject.parse_schedule(spec)):
        res = sim.march(prob, scen, _quick_cfg(sim), mode=mode,
                        setup_opts=SETUP_OPTS)
    with rinject.active(rinject.parse_schedule(spec)):
        want = rsim.march(rprob, rscen, _quick_cfg(rsim), mode=mode,
                          setup_opts=SETUP_OPTS)
    assert inject.current() is None
    _check_march(res, want)
    return res


def test_march_transient_fault_recovered(port, ref):
    res = _faulted(port, ref, "spmv:nan@1", "adaptive")
    assert res.status == "ok" and res.steps_done == 3
    assert res.n_recoveries >= 1
    assert (res.step_status == health.HEALTHY).all()
    bad = res.attempts[0]
    assert bad["status"] == health.NONFINITE and bad["iters"] <= 2
    assert res.worst_status == health.NONFINITE
    assert (res.relres <= 1e-8).all()


def test_march_persistent_fault_fails_explicitly(port, ref):
    res = _faulted(port, ref, "spmv:nan@1:persistent", "adaptive")
    assert res.status == "failed" and res.steps_done == 0
    assert res.n_recoveries == 2
    assert len(res.attempts) == 3
    assert all(a["status"] == health.NONFINITE for a in res.attempts)


def test_frozen_march_never_advances_on_poison(port, ref):
    res = _faulted(port, ref, "spmv:nan@1", "frozen")
    assert res.status == "failed" and res.steps_done == 0
    assert len(res.iters) == 0 and len(res.attempts) == 3
    assert res.worst_status == health.NONFINITE
    assert torch.equal(res.x, torch.zeros_like(res.x))


def test_march_counters_in_the_default_registry(port):
    from repro_torch.obs.metrics import default_registry, \
        reset_default_registry
    prob, scen = port
    reset_default_registry()
    res = sim.march(prob, scen, _quick_cfg(sim), mode="resetup",
                    setup_opts=SETUP_OPTS)
    reg = default_registry()
    lab = {"mode": "resetup"}
    assert reg.counter("march/setups").value(lab) == res.n_setups == 3
    assert reg.counter("march/segments").value(lab) == 3
    assert reg.counter("march/steps").value(lab) == 3
    assert reg.counter("march/solve_iters").value(lab) == res.total_iters
    assert [s.steps for s in res.segments] == [1, 1, 1]


# ---------------------------------------------------------------------------
# The acceptance battery (slow): m=5 softening, the reference's settings
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_march_acceptance_adaptive_vs_frozen_vs_resetup():
    prob = assemble_elasticity(5, device="cpu")
    scen = sim.SofteningScenario.build(prob, rate=0.25, d_max=0.99)
    cfg = sim.MarchConfig(n_steps=8, seg_len=8, rtol=1e-10, maxiter=400,
                          staleness=sim.StalenessConfig(iter_drift=2,
                                                        ref_window=2,
                                                        coeff_rtol=0.25))
    runs = {mode: sim.march(prob, scen, cfg, mode=mode,
                            setup_opts=SETUP_OPTS)
            for mode in ("frozen", "adaptive", "resetup")}
    for mode, res in runs.items():
        assert res.status == "ok" and res.steps_done == 8, mode
        assert (res.step_status == health.HEALTHY).all(), mode
    adaptive, frozen, resetup = (runs["adaptive"], runs["frozen"],
                                 runs["resetup"])
    rel = float(torch.linalg.vector_norm(adaptive.x - resetup.x)
                / torch.linalg.vector_norm(resetup.x))
    assert rel <= 1e-10, rel
    assert adaptive.n_setups < resetup.n_setups
    assert adaptive.total_iters < frozen.total_iters
    assert frozen.iters[-1] > frozen.iters[0]
