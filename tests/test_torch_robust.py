"""The port's robustness layer against ``repro.robust``: twins of
``tests/test_robust.py`` (health flags on constructed failures, the
best-iterate contract, the hardened coarse Cholesky, the fault-spec
language, the env resolvers, the ladder's plumbing and the status
helpers), then the ladder's outcomes on port and reference alike at m=6
(greedy, ``coarse_size=100``) for the schedules ``chip_smoke.py`` runs at
m=32, and the server's retry.  The twins of ``tests/test_fault_battery.py``
are marked ``slow``.

One pin differs by design: the reference pins an empty schedule as zero
jaxpr residue; the port, which traces nothing, pins ``maybe(site, x) is
x`` — no copy, no launch — with no schedule or with a gate that does not
match.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as rgamg  # noqa: E402
from repro.core.krylov import pcg as ref_pcg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.multirhs import AMGSolveServer as RefServer  # noqa: E402
from repro.multirhs.block_krylov import block_pcg as ref_block_pcg  # noqa
from repro.robust import health as rhealth  # noqa: E402
from repro.robust import inject as rinject  # noqa: E402
from repro.robust import recover as rrecover  # noqa: E402

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.krylov import pcg  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.multirhs import AMGSolveServer  # noqa: E402
from repro_torch.multirhs.block_krylov import block_pcg  # noqa: E402
from repro_torch.robust import health, inject  # noqa: E402
from repro_torch.robust.recover import (  # noqa: E402
    RecoveryPolicy,
    RobustSolver,
    _env_scope,
    ladder_solve,
    reference_path_env,
)

from torch_helpers import assert_close, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(23)


def _spd(n, dtype=np.float64, cond=1e4, rng=RNG):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, np.log10(cond), n)
    return ((Q * eigs) @ Q.T).astype(dtype)


def _both(A, b, m=None, **kw):
    """``pcg`` of the port and of the reference on one dense problem (a
    preconditioner ``m``: a callable on numpy-like arrays, default the
    identity)."""
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    mt = (lambda v: v) if m is None else (lambda v: m(v))
    port = pcg(lambda v: At @ v, mt, bt, **kw)
    ref = ref_pcg(lambda v: Aj @ v, mt, bj, **kw)
    return port, ref


def _same_outcome(port, ref):
    assert int(port.health.status) == int(ref.health.status)
    assert int(port.iters) == int(ref.iters)
    assert bool(port.converged) == bool(ref.converged)


@pytest.fixture(scope="module")
def prob():
    return assemble_elasticity(4, device="cpu")


@pytest.fixture(scope="module")
def solver(prob):
    return gamg.GAMGSolver(prob.A, prob.B, coarse_size=30, rtol=1e-8,
                           maxiter=100, precision="f64")


# ---------------------------------------------------------------------------
# Healthy path: monitoring and the fault hook are free
# ---------------------------------------------------------------------------

def _vanilla_pcg(apply_a, apply_m, b, rtol, maxiter):
    """The recurrence with no monitoring, the same primitives."""
    x = torch.zeros_like(b)
    r = b - apply_a(x)
    z = apply_m(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.clamp_min(torch.linalg.vector_norm(b),
                            torch.finfo(b.dtype).tiny)
    rnorm = torch.linalg.vector_norm(r)
    k = 0
    while k < maxiter and bool(rnorm > rtol * bnorm):
        Ap = apply_a(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = torch.linalg.vector_norm(r)
        k += 1
    return x, k, rnorm / bnorm


def test_monitored_pcg_bitwise_matches_unmonitored():
    A = torch.from_numpy(_spd(40))
    dinv = 1.0 / torch.diagonal(A)
    b = torch.from_numpy(RNG.standard_normal(40))
    res = pcg(lambda v: A @ v, lambda v: dinv * v, b, rtol=1e-10,
              maxiter=200)
    xv, kv, rrv = _vanilla_pcg(lambda v: A @ v, lambda v: dinv * v, b,
                               1e-10, 200)
    assert bool(res.converged) and res.iters == kv
    assert torch.equal(res.x, xv) and torch.equal(res.relres, rrv)
    assert int(res.health.status) == health.HEALTHY
    assert not (bool(res.health.breakdown) or bool(res.health.nonfinite)
                or bool(res.health.stagnation))


def test_maybe_is_the_input_without_a_firing_fault():
    x = torch.arange(6.0, dtype=torch.float64)
    assert inject.current() is None
    for site in inject.SITES:
        assert inject.maybe(site, x) is x
        assert inject.maybe(site, x, step=3, level=1) is x
    sched = inject.parse_schedule("spmv:nan@5;hierarchy:inf:level=2")
    with inject.active(sched):
        assert inject.current() is sched
        assert inject.maybe("spmv", x, step=4) is x        # step gate
        assert inject.maybe("hierarchy", x, level=1) is x  # level gate
        assert inject.maybe("precond", x, step=5) is x     # other site
        hit = inject.maybe("spmv", x, step=5)
        assert hit is not x and torch.isnan(hit[0])
        assert torch.equal(x, torch.arange(6.0, dtype=torch.float64))
    assert inject.current() is None


def test_block_pcg_reports_per_column_health(solver, prob):
    B = torch.stack([prob.b, 3.0 * prob.b], dim=1)
    res = solver.solve_many(B)
    assert tuple(res.health.status.shape) == (2,)
    assert res.health.status.tolist() == [0, 0]
    assert bool(res.converged.all())
    assert float(res.health.best_relres.max()) <= 1e-8


# ---------------------------------------------------------------------------
# Detection on constructed failures, held against the reference
# ---------------------------------------------------------------------------

def test_breakdown_detected_indefinite_preconditioner():
    A, b = _spd(20), RNG.standard_normal(20)
    port, ref = _both(A, b, m=lambda v: -v, rtol=1e-10, maxiter=50)
    _same_outcome(port, ref)
    assert int(port.health.status) == health.BREAKDOWN
    assert port.iters == 0 and bool(torch.isfinite(port.x).all())


def test_breakdown_detected_indefinite_operator():
    d = np.ones(10)
    d[0] = -50.0
    port, ref = _both(np.diag(d), np.ones(10), rtol=1e-10, maxiter=50)
    _same_outcome(port, ref)
    assert int(port.health.status) == health.BREAKDOWN
    assert bool(torch.isfinite(port.x).all())
    assert_close(port.x, ref.x)


def test_nonfinite_detected_poison_rhs():
    b = RNG.standard_normal(8)
    b[3] = np.nan
    port, ref = _both(_spd(8), b, rtol=1e-10, maxiter=50)
    _same_outcome(port, ref)
    assert int(port.health.status) == health.NONFINITE
    assert port.iters == 0 and bool(torch.isfinite(port.x).all())


def test_stagnation_detected_no_new_best_over_window():
    rng = np.random.default_rng(23)
    n = 30
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, 4, n)) @ Q.T
    b = rng.standard_normal(n)
    port, ref = _both(A, b, rtol=1e-10, maxiter=5000, stall_window=10)
    _same_outcome(port, ref)
    assert int(port.health.status) == health.STAGNATION
    assert port.iters < 100
    assert float(port.health.best_relres) <= 1.0
    assert bool(torch.isfinite(port.x).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_best_iterate_on_early_termination(dtype):
    """A non-converged exit returns the minimum-residual iterate, which
    achieves the reported ``relres``; as the reference's."""
    n = 60
    A = _spd(n, cond=1e8, rng=np.random.default_rng(4)).astype(dtype)
    b = np.random.default_rng(5).standard_normal(n).astype(dtype)
    port, ref = _both(A, b, rtol=1e-12, maxiter=25, stall_window=10 ** 6)
    _same_outcome(port, ref)
    assert not bool(port.converged)
    assert float(port.relres) == float(port.health.best_relres)
    eps = float(np.finfo(dtype).eps)
    bnorm = float(np.linalg.norm(b))
    true_rel = float(np.linalg.norm(b - A @ port.x.numpy())) / bnorm
    np.testing.assert_allclose(true_rel, float(port.relres),
                               rtol=200 * eps * np.sqrt(n))
    np.testing.assert_allclose(float(port.health.best_relres),
                               float(ref.health.best_relres),
                               rtol=1e-12 if dtype == np.float64 else 1e-3)
    assert int(port.health.best_iter) == int(ref.health.best_iter)


def test_block_best_iterate_early_termination():
    n = 60
    A = _spd(n, cond=1e8, rng=np.random.default_rng(6))
    B = np.random.default_rng(7).standard_normal((n, 3))
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    res = block_pcg(lambda V: At @ V, lambda V: V, torch.from_numpy(B),
                    rtol=1e-12, maxiter=25, stall_window=10 ** 6)
    ref = ref_block_pcg(lambda V: Aj @ V, lambda V: V, jnp.asarray(B),
                        rtol=1e-12, maxiter=25, stall_window=10 ** 6)
    assert not bool(res.converged.any())
    true_rel = np.linalg.norm(B - A @ res.x.numpy(), axis=0) / \
        np.linalg.norm(B, axis=0)
    np.testing.assert_allclose(true_rel, res.relres.numpy(), rtol=1e-9)
    assert torch.equal(res.relres, res.health.best_relres)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert_close(res.relres, ref.relres)


# ---------------------------------------------------------------------------
# The hardened coarse Cholesky
# ---------------------------------------------------------------------------

def test_jittered_cholesky_base_path_bitwise_legacy():
    dense = torch.from_numpy(_spd(12))
    pol = PrecisionPolicy.double()
    scale = pol.coarse_jitter_scale()
    got = gamg.jittered_cholesky(dense, scale, pol.coarse_retry_scale())
    n = dense.shape[0]
    eye = torch.eye(n, dtype=dense.dtype)
    legacy = torch.linalg.cholesky(dense + (scale * torch.trace(dense) / n)
                                   * eye)
    assert torch.equal(got, legacy)


def test_jittered_cholesky_recovers_rank_deficient():
    Q, _ = np.linalg.qr(RNG.standard_normal((16, 16)))
    eigs = np.ones(16)
    eigs[-1] = -1e-10
    M = (Q * eigs) @ Q.T
    dense = torch.from_numpy(0.5 * (M + M.T))
    pol = PrecisionPolicy.double()
    base = pol.coarse_jitter_scale()
    eye = torch.eye(16, dtype=dense.dtype)
    _, info = torch.linalg.cholesky_ex(
        dense + (base * torch.trace(dense) / 16) * eye)
    assert int(info) != 0, "the case must defeat the base jitter"
    got = gamg.jittered_cholesky(dense, base, pol.coarse_retry_scale())
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose((got @ got.T).numpy(), dense.numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The fault-spec language, faults, resolvers
# ---------------------------------------------------------------------------

SPEC = "precond:nan@3; halo:bitflip:index=7:persistent;hierarchy:inf:level=1"


def test_parse_schedule_round_trip():
    s = inject.parse_schedule(SPEC)
    r = rinject.parse_schedule(SPEC)
    fields = ("site", "kind", "step", "level", "index", "transient")
    assert [tuple(getattr(f, k) for k in fields) for f in s.faults] == \
        [tuple(getattr(f, k) for k in fields) for f in r.faults]
    f0, f1, f2 = s.faults
    assert (f0.site, f0.kind, f0.step, f0.transient) == \
        ("precond", "nan", 3, True)
    assert (f1.site, f1.kind, f1.index, f1.transient) == \
        ("halo", "bitflip", 7, False)
    assert (f2.site, f2.kind, f2.level) == ("hierarchy", "inf", 1)
    kept = s.without_transient()
    assert kept is not None and [f.site for f in kept.faults] == ["halo"]
    assert inject.parse_schedule("spmv:nan").without_transient() is None
    assert inject.SITES == rinject.SITES and inject.KINDS == rinject.KINDS


@pytest.mark.parametrize("bad", ["bogus:nan", "spmv:frob", "spmv",
                                 "spmv:nan:wat=3", "spmv:nan:persistent:x",
                                 ""])
def test_parse_schedule_rejects(bad):
    with pytest.raises(ValueError):
        inject.parse_schedule(bad)
    with pytest.raises(ValueError):
        rinject.parse_schedule(bad)


def _bits(a):
    a = to_np(a.view(torch.int16)) if isinstance(a, torch.Tensor) \
        and a.dtype == torch.bfloat16 else to_np(a)
    return a.view(np.uint8)


@pytest.mark.parametrize("kind", inject.KINDS)
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_corrupt_is_bitwise_the_references(kind, dt):
    """A firing fault corrupts the same element to the same bits as the
    reference's on the same input (a NaN to a NaN: XLA canonicalises the
    payload of a bf16 NaN that a flip produces, the port keeps the flipped
    bits); the gate leaves the input alone."""
    tdt = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}[dt]
    jdt = {"f64": jnp.float64, "f32": jnp.float32,
           "bf16": jnp.bfloat16}[dt]
    src = np.random.default_rng(1).uniform(-1.5, 1.5, (5, 3))
    if dt != "f64":     # one rounding to bf16 on both sides (from f32)
        src = src.astype(np.float32)
    x = torch.from_numpy(src).to(tdt)
    xj = jnp.asarray(src).astype(jdt)
    np.testing.assert_array_equal(_bits(x), _bits(np.asarray(xj)))
    f = inject.Fault(site="spmv", kind=kind, step=2, index=9)
    rf = rinject.Fault(site="spmv", kind=kind, step=2, index=9)
    assert f.corrupt(x, step=0) is x
    got = f.corrupt(x, step=2)
    want = rf.corrupt(xj, step=jnp.asarray(2))
    assert got.dtype == tdt and tuple(got.shape) == (5, 3)
    want = np.asarray(want)
    with np.errstate(invalid="ignore"):
        nan = np.isnan(want.astype(np.float64))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    # element 9 is -1.417...: its flipped exponent is all ones, a NaN
    assert nan.sum() == (kind != "inf")
    keep = np.repeat(~nan.reshape(-1), got.element_size())
    np.testing.assert_array_equal(_bits(got).reshape(-1)[keep],
                                  _bits(want).reshape(-1)[keep])
    assert torch.equal(x, torch.from_numpy(src).to(tdt))   # untouched
    np.testing.assert_array_equal(_bits(got),               # deterministic
                                  _bits(f.corrupt(x, step=None)))


def test_bitflip_lands_finite_huge_on_a_small_value():
    fb = inject.Fault(site="spmv", kind="bitflip", index=0)
    src = torch.full((4,), 0.5, dtype=torch.float64)
    flipped = fb.corrupt(src).numpy()
    assert flipped[0] > 1e300 and np.isfinite(flipped[0])
    np.testing.assert_array_equal(flipped[1:], 0.5)


def test_resolve_faults_env_and_passthrough(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FAULTS", raising=False)
    monkeypatch.setenv("REPRO_FAULTS", "spmv:nan@1")   # never read
    assert backend.resolve_faults() is None
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "spmv:nan@1")
    sched = backend.resolve_faults()
    assert isinstance(sched, inject.FaultSchedule)
    assert sched.faults[0].site == "spmv"
    explicit = inject.parse_schedule("halo:inf")
    assert backend.resolve_faults(explicit) is explicit
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "bogus:nan")
    with pytest.raises(ValueError):
        backend.resolve_faults()


def test_resolve_recover_env_and_passthrough(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_RECOVER", raising=False)
    monkeypatch.setenv("REPRO_RECOVER", "on")          # never read
    assert backend.resolve_recover() is None
    for off in ("off", "0", "false", "none"):
        monkeypatch.setenv("REPRO_TORCH_RECOVER", off)
        assert backend.resolve_recover() is None
    monkeypatch.setenv("REPRO_TORCH_RECOVER", "on")
    assert backend.resolve_recover() == RecoveryPolicy()
    monkeypatch.setenv("REPRO_TORCH_RECOVER", "2")
    assert backend.resolve_recover().max_attempts == 2
    monkeypatch.delenv("REPRO_TORCH_RECOVER", raising=False)
    pol = RecoveryPolicy(max_attempts=1)
    assert backend.resolve_recover(pol) is pol
    monkeypatch.setenv("REPRO_TORCH_RECOVER", "sometimes")
    with pytest.raises(ValueError, match="invalid recovery knob"):
        backend.resolve_recover()


def test_env_arms_the_schedule_at_import():
    """``REPRO_TORCH_FAULTS`` arms a fresh process; ``REPRO_FAULTS`` does
    not."""
    code = ("from repro_torch.robust import inject; s = inject.current(); "
            "print(None if s is None else [f.site for f in s.faults])")
    out = {}
    for var in ("REPRO_TORCH_FAULTS", "REPRO_FAULTS"):
        env = {k: v for k, v in os.environ.items()
               if k not in ("REPRO_TORCH_FAULTS", "REPRO_FAULTS")}
        env.update({var: "precond:nan@2;coarse:inf",
                    "PYTHONPATH": str(ROOT / "src")})
        out[var] = subprocess.run(
            [sys.executable, "-c", code], env=env, capture_output=True,
            text=True, check=True, timeout=120).stdout.strip()
    assert out == {"REPRO_TORCH_FAULTS": "['precond', 'coarse']",
                   "REPRO_FAULTS": "None"}


def test_recovery_policy_validation():
    with pytest.raises(ValueError):
        RecoveryPolicy(max_attempts=0)


# ---------------------------------------------------------------------------
# Ladder plumbing
# ---------------------------------------------------------------------------

def test_robust_solver_healthy_is_single_solve(prob):
    rs = RobustSolver(prob.A, prob.B, coarse_size=30, rtol=1e-8,
                      maxiter=100, precision="f64")
    solve, hier = rs._solve, rs.hierarchy
    out = rs.solve(prob.b)
    assert out.status == "ok" and out.attempts == ()
    assert rs.describe_last() == "(no recovery needed)"
    assert rs.n_recoveries == 0 and rs.hierarchy_ok()
    assert rs.solve(2.0 * prob.b).status == "ok"
    # the healthy path rebuilds nothing
    assert rs._solve is solve and rs.hierarchy is hier


def test_rung_order_and_policy_gating(prob):
    rs = RobustSolver(prob.A, prob.B, coarse_size=30, precision="f64")
    assert [n for n, _, _ in rs._rungs()] == \
        ["recompute", "re-setup", "reference-path"]
    rs.recovery = RecoveryPolicy(max_attempts=1)
    assert [n for n, _, _ in rs._rungs()] == ["recompute"]
    rs.recovery = RecoveryPolicy(allow_recompute=False, max_attempts=4)
    assert [n for n, _, _ in rs._rungs()] == ["re-setup", "reference-path"]
    # the last rung's knobs: the plain path on the CPU, the pairs kernels
    # on a card (the port runs no plain version there)
    assert rs._rungs()[-1][1] == {"REPRO_TORCH_SPGEMM_PATH": "reference"}
    assert reference_path_env("cuda") == \
        {"REPRO_TORCH_SPGEMM_PATH": "pairs"}


def test_f64_rebuild_rung_offered_for_reduced_precision(prob):
    rs = RobustSolver(prob.A, prob.B, coarse_size=30, precision="f32",
                      recovery=RecoveryPolicy(max_attempts=4))
    names = [n for n, _, _ in rs._rungs()]
    assert names == ["recompute", "re-setup", "f64-rebuild",
                     "reference-path"]


def test_ladder_solve_one_shot(prob):
    out = ladder_solve(prob.A, prob.B, prob.b, coarse_size=30, rtol=1e-8,
                       maxiter=100, precision="f64")
    assert out.status == "ok"
    assert float(out.result.relres) <= 1e-8
    assert bool(torch.isfinite(out.x).all())


def test_env_scope_restores(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "pairs")
    monkeypatch.delenv("REPRO_TORCH_SMOOTH_PATH", raising=False)
    with _env_scope({"REPRO_TORCH_SPGEMM_PATH": "reference",
                     "REPRO_TORCH_SMOOTH_PATH": "reference"}):
        assert os.environ["REPRO_TORCH_SPGEMM_PATH"] == "reference"
        assert os.environ["REPRO_TORCH_SMOOTH_PATH"] == "reference"
    assert os.environ["REPRO_TORCH_SPGEMM_PATH"] == "pairs"
    assert "REPRO_TORCH_SMOOTH_PATH" not in os.environ


def test_status_of_severity_order():
    t, f = torch.tensor(True), torch.tensor(False)
    assert int(health.status_of(t, f, f, f)) == health.HEALTHY
    assert int(health.status_of(f, f, f, f)) == health.MAXITER
    assert int(health.status_of(f, f, f, t)) == health.STAGNATION
    assert int(health.status_of(f, t, f, t)) == health.BREAKDOWN
    assert int(health.status_of(f, t, t, t)) == health.NONFINITE
    codes = health.status_of(torch.tensor([True, False]),
                             torch.tensor([False, True]),
                             torch.tensor([False, False]),
                             torch.tensor([False, False]))
    assert codes.tolist() == [0, 3]
    assert health.STATUS_NAMES == rhealth.STATUS_NAMES


def test_worst_status_and_summary_match_reference():
    codes = [0, 1, 0, 4, 2, 0]
    want = int(rhealth.worst_status(codes))
    assert int(health.worst_status(codes)) == want == health.NONFINITE
    assert int(health.worst_status(np.asarray(codes))) == want
    t = health.worst_status(torch.tensor(codes, dtype=torch.int32))
    assert isinstance(t, torch.Tensor) and int(t) == want
    assert int(health.worst_status([torch.tensor(c) for c in codes])) == want
    assert health.summarize_statuses(codes) == \
        rhealth.summarize_statuses(np.asarray(codes))
    assert health.summarize_statuses(torch.tensor(codes)) == \
        rhealth.summarize_statuses(np.asarray(codes))
    assert health.summarize_statuses([]) == {"worst": "healthy"}


def test_describe_and_hierarchy_finite(solver, prob):
    res = solver.solve(prob.b)
    line = health.describe(res.health)
    assert "healthy" in line and "best_relres" in line
    assert bool(health.hierarchy_finite(solver.hierarchy))
    with inject.active(inject.parse_schedule("hierarchy:nan:level=1")):
        bad = gamg.recompute(solver.setup_data, prob.A.data)
    assert not bool(health.hierarchy_finite(bad))
    stored = gamg.setup(prob.A, prob.B, coarse_size=30,
                        restriction="stored")
    sh = gamg.recompute(stored, prob.A.data)
    assert bool(health.hierarchy_finite(sh))
    sh.levels[0].r_ell.data[0, 0, 0, 0] = float("inf")
    assert not bool(health.hierarchy_finite(sh))


# ---------------------------------------------------------------------------
# The ladder on port and reference, m=6 (chip_smoke.py's robust path
# schedules, at the paper's configuration cut to m=6)
# ---------------------------------------------------------------------------

M6 = dict(coarse_size=100, coarsener="greedy")


@pytest.fixture(scope="module")
def m6():
    return (assemble_elasticity(6, path="host", device="cpu"),
            ref_assemble(6, path="host"))


LADDER = {
    "healthy": (None, {}),
    "transient": ("precond:nan@3", {}),
    "persistent": ("precond:nan@3:persistent", {}),
    # a bf16 setup whose first two rungs are withheld, so the f64 rebuild
    # is what answers (at m=6 the bf16 factor is finite; at m=32 on the
    # card, chip_smoke.py climbs all three rungs to it)
    "bf16": ("precond:nan@0", dict(
        precision="bf16", recovery=dict(allow_recompute=False,
                                        allow_resetup=False))),
}


def _ladder(pkg, prob, spec, kw):
    inj, Solver, Policy = pkg
    kw = dict(kw)
    if "recovery" in kw:
        kw["recovery"] = Policy(**kw["recovery"])
    sched = inj.parse_schedule(spec) if spec else None
    with inj.active(sched):
        s = Solver(prob.A, prob.B, **M6, **kw)
        return s.solve(prob.b)


@pytest.mark.parametrize("case", list(LADDER))
def test_ladder_outcomes_match_reference(m6, case):
    """Status, rungs and iterations equal; the solution within 1e-12; a
    failed solution all zeros; the healthy and the recovered solutions
    bitwise one another."""
    pp, rp = m6
    spec, kw = LADDER[case]
    got = _ladder((inject, RobustSolver, RecoveryPolicy), pp, spec, kw)
    want = _ladder((rinject, rrecover.RobustSolver,
                    rrecover.RecoveryPolicy), rp, spec, kw)
    expect = {"healthy": ("ok", ()), "transient": ("recovered",
                                                   ("recompute",)),
              "persistent": ("degraded", ("recompute", "re-setup",
                                          "reference-path")),
              "bf16": ("recovered", ("f64-rebuild",))}[case]
    assert (got.status, got.attempts) == (want.status, want.attempts) \
        == expect
    assert got.result.iters == int(want.result.iters)
    assert_close(got.x, want.x)
    if got.status == "failed":
        assert not bool(got.x.any())
    if case in ("healthy", "transient"):
        again = _ladder((inject, RobustSolver, RecoveryPolicy), pp, None, {})
        assert torch.equal(got.x, again.x)


def test_traced_binds_the_schedule_per_signature():
    """``inject.traced`` keeps, per argument signature, the schedule and
    knobs of its first call with that signature, as a jit trace does: a
    closure first called clean stays clean under a later schedule, a new
    shape binds the schedule then installed, and the bound schedule holds
    after it is cleared."""
    knob = {"path": "fused"}
    seen = []

    def fn(x, *, path):
        seen.append(path)
        return inject.maybe("spmv", x)

    f = inject.traced(fn, lambda: dict(knob))
    x3, x4 = torch.ones(3, dtype=torch.float64), torch.ones(4)
    assert f(x3) is x3
    knob["path"] = "pairs"
    with inject.active(inject.parse_schedule("spmv:nan")):
        assert f(x3) is x3
        assert bool(torch.isnan(f(x4)[0]))
    assert bool(torch.isnan(f(x4)[0])) and f(x3) is x3
    assert seen == ["fused", "fused", "pairs", "pairs", "fused"]
    assert inject.current() is None


def test_second_solve_after_recovery_is_ok(m6):
    """Under one transient schedule the first solve recovers and the
    second, on the rung's rebuilt closures, is ``ok`` with the recovered
    solution, on port and reference alike (the reference's rebuilt traces
    are clean of the transient fault; the port's closures bind the
    suppressed schedule at their first call)."""
    pp, rp = m6
    spec = "precond:nan@3"
    with inject.active(inject.parse_schedule(spec)):
        rs = RobustSolver(pp.A, pp.B, **M6)
        got = [rs.solve(pp.b) for _ in range(2)]
    with rinject.active(rinject.parse_schedule(spec)):
        ref = rrecover.RobustSolver(rp.A, rp.B, **M6)
        want = [ref.solve(rp.b) for _ in range(2)]
    assert [(r.status, r.attempts) for r in got] == \
        [(r.status, r.attempts) for r in want] == \
        [("recovered", ("recompute",)), ("ok", ())]
    assert [r.result.iters for r in got] == \
        [int(r.result.iters) for r in want]
    assert torch.equal(got[0].x, got[1].x)
    assert_close(got[1].x, want[1].x)


def test_update_operator_after_reference_path_rung_keeps_its_path(
        m6, monkeypatch):
    """After an exhausted ladder whose last rung is "reference-path",
    ``update_operator`` runs on that rung's closures: the port's keep the
    rung's SpGEMM path (``reference`` on the CPU; ``pairs``, hence
    ``block_pair_gemm``, on the card: ``tests/test_torch_cuda.py``) once
    the rung's environment is restored, and the reference's do not
    retrace.  The updated hierarchies agree."""
    pp, rp = m6
    spec = "precond:nan@3:persistent"
    with inject.active(inject.parse_schedule(spec)):
        rs = RobustSolver(pp.A, pp.B, **M6)
        assert rs.solve(pp.b).attempts[-1] == "reference-path"
    with rinject.active(rinject.parse_schedule(spec)):
        ref = rrecover.RobustSolver(rp.A, rp.B, **M6)
        assert ref.solve(rp.b).attempts[-1] == "reference-path"
    monkeypatch.delenv("REPRO_TORCH_SPGEMM_PATH", raising=False)
    monkeypatch.delenv("REPRO_SPGEMM_PATH", raising=False)
    seen = {"port": [], "ref": []}

    def spy(resolve, log):
        def wrapped(*args, **kw):
            path = resolve(*args, **kw)
            log.append(path)
            return path
        return wrapped

    from repro.kernels import backend as rbackend
    monkeypatch.setattr(backend, "resolve_spgemm_path",
                        spy(backend.resolve_spgemm_path, seen["port"]))
    monkeypatch.setattr(rbackend, "resolve_spgemm_path",
                        spy(rbackend.resolve_spgemm_path, seen["ref"]))
    rs.update_operator(1.1 * pp.A.data)
    ref.update_operator(1.1 * rp.A.data)
    assert seen["port"] and set(seen["port"]) == {"reference"}
    assert seen["ref"] == []
    assert_close(rs.hierarchy.levels[0].a_ell.data,
                 ref.hierarchy.levels[0].a_ell.data)
    assert_close(rs.hierarchy.coarse_chol, ref.hierarchy.coarse_chol)
    fresh = gamg.make_recompute(rs.setupd)
    seen["port"].clear()
    fresh(pp.A.data)
    assert set(seen["port"]) == {"fused"}


def test_server_retry_matches_reference(m6):
    """A transient ``precond`` fault poisons column 0 of the panel; with
    ``recover=`` its report comes back ``recovered`` after one retry and
    its neighbours ``ok``, as the reference's; without it, ``failed``."""
    pp, rp = m6
    rng = np.random.default_rng(0)
    rhs = [pp.b.numpy()] + [rng.standard_normal(pp.n) for _ in range(3)]
    ps = gamg.setup(pp.A, pp.B, **M6)
    rs = rgamg.setup(rp.A, rp.B, **M6)
    spec = "precond:nan@3"
    with inject.active(inject.parse_schedule(spec)):
        srv = AMGSolveServer(ps, pp.A.data, buckets=(1, 2, 4),
                             recover=RecoveryPolicy())
        got = srv.serve(rhs)
        plain = AMGSolveServer(ps, pp.A.data, buckets=(4,)).serve(rhs[:2])
    with rinject.active(rinject.parse_schedule(spec)):
        want = RefServer(rs, rp.A.data, buckets=(1, 2, 4),
                         recover=rrecover.RecoveryPolicy()).serve(rhs)
    assert [(r.status, r.iters, r.converged) for r in got] == \
        [(r.status, r.iters, r.converged) for r in want]
    assert [r.status for r in got] == ["recovered", "ok", "ok", "ok"]
    for g, w in zip(got, want):
        assert_close(g.x, w.x)
    assert srv.stats["recovered"] == 1
    assert srv.metrics().registry.histogram(
        "server/retry_seconds").snapshot()["count"] == 1
    assert plain[0].status == "failed" and not plain[0].x.any()


def test_server_persistent_fault_stays_failed(m6):
    pp, _ = m6
    ps = gamg.setup(pp.A, pp.B, **M6)
    with inject.active(inject.parse_schedule("precond:nan@3:persistent")):
        srv = AMGSolveServer(ps, pp.A.data, buckets=(2,),
                             recover=RecoveryPolicy())
        reps = srv.serve([pp.b.numpy(), 2.0 * pp.b.numpy()])
    assert [r.status for r in reps] == ["failed", "ok"]
    assert not reps[0].x.any()


def test_server_recover_from_env(m6, monkeypatch):
    pp, _ = m6
    ps = gamg.setup(pp.A, pp.B, **M6)
    monkeypatch.setenv("REPRO_TORCH_RECOVER", "on")
    assert AMGSolveServer(ps, pp.A.data).recover == RecoveryPolicy()
    monkeypatch.setenv("REPRO_TORCH_RECOVER", "off")
    assert AMGSolveServer(ps, pp.A.data).recover is None


# ---------------------------------------------------------------------------
# tests/test_fault_battery.py's deterministic cases (slow)
# ---------------------------------------------------------------------------

BATTERY = [
    ("spmv:nan@1", health.NONFINITE), ("spmv:inf@1", health.NONFINITE),
    ("spmv:bitflip@1", None), ("precond:nan@2", health.NONFINITE),
    ("precond:inf@2", health.NONFINITE), ("precond:bitflip@2", None),
    ("vcycle:nan", health.NONFINITE), ("vcycle:inf", health.NONFINITE),
    ("coarse:nan", health.NONFINITE), ("coarse:inf", health.NONFINITE),
    ("hierarchy:nan", health.NONFINITE), ("hierarchy:inf", health.NONFINITE),
    ("hierarchy:nan:level=1", health.NONFINITE),
]


@pytest.fixture(scope="module")
def ref4():
    return ref_assemble(4)


@pytest.mark.slow
@pytest.mark.parametrize("spec,expect", BATTERY,
                         ids=[c[0] for c in BATTERY])
def test_fault_detected_and_contained(prob, ref4, spec, expect):
    """Flagged, not converged, a finite ``x`` — with the reference's
    status and iterations."""
    opts = dict(coarse_size=30, rtol=1e-8, maxiter=100, precision="f64")
    with inject.active(inject.parse_schedule(spec)):
        res = gamg.GAMGSolver(prob.A, prob.B, **opts).solve(prob.b)
    with rinject.active(rinject.parse_schedule(spec)):
        want = rgamg.GAMGSolver(ref4.A, ref4.B, **opts).solve(ref4.b)
    assert int(res.health.status) != health.HEALTHY
    assert not bool(res.converged)
    assert bool(torch.isfinite(res.x).all())
    assert int(res.health.status) == int(want.health.status)
    assert res.iters == int(want.iters)
    if expect is not None:
        assert int(res.health.status) == expect


@pytest.mark.slow
def test_clean_run_after_battery_is_bitwise_clean(prob):
    assert inject.current() is None
    opts = dict(coarse_size=30, rtol=1e-8, maxiter=100)
    r1 = gamg.GAMGSolver(prob.A, prob.B, **opts).solve(prob.b)
    with inject.active(inject.parse_schedule("spmv:nan@1")):
        pass
    r2 = gamg.GAMGSolver(prob.A, prob.B, **opts).solve(prob.b)
    assert torch.equal(r1.x, r2.x) and r1.iters == r2.iters
