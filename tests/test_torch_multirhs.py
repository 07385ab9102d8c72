"""The port's multi-RHS path against ``repro``: panel products, the panel
V-cycle, ``solve_many`` and the solve server on interop-converted
reference setups, plus the "pairs" Galerkin recompute and the host-side
metrics."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core import vcycle as ref_vcycle  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.multirhs import AMGSolveServer as RefServer  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core import vcycle  # noqa: E402
from repro_torch.core.spmv import apply_ell, spmm  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy, \
    setup_from_numpy  # noqa: E402
from repro_torch.multirhs import AMGSolveServer, SolveReport  # noqa: E402
from repro_torch.multirhs.block_krylov import make_block_solve  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

from torch_helpers import CASE_IDS, CASES, assert_close, \
    hierarchy_to_numpy, rel_err, setup_to_numpy  # noqa: E402

SOLUTION = 1e-9     # whole-solve agreement (CG amplifies rounding)


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def ref(request):
    """The reference problem and solver, and the port's interop-converted
    setup and hierarchy on the CPU."""
    m, coarse_size, rows, iters = request.param
    prob = ref_assemble(m, path="host")
    solver = ref_gamg.GAMGSolver(prob.A, prob.B, coarse_size=coarse_size,
                                 coarsener="greedy", rtol=1e-8, maxiter=200)
    levels, coarse = setup_to_numpy(solver.setup_data)
    hl, chol = hierarchy_to_numpy(solver.hierarchy)
    return dict(m=m, coarse_size=coarse_size, prob=prob, solver=solver,
                iters=iters,
                port_setup=setup_from_numpy(levels, coarse,
                                            coarsener="greedy",
                                            device="cpu"),
                port_hier=hierarchy_from_numpy(hl, chol, device="cpu"))


def _panel(ref, k, seed=0):
    n = ref["prob"].A.shape[0]
    return np.random.default_rng(ref["m"] * 10 + seed).standard_normal(
        (n, k))


def test_width_one_panel_is_bitwise_the_vector_apply(ref):
    a = ref["port_hier"].levels[0].a_ell
    X = torch.as_tensor(_panel(ref, 1))
    np.testing.assert_array_equal(apply_ell(a, X)[:, 0].numpy(),
                                  apply_ell(a, X[:, 0]).numpy())
    Y = torch.as_tensor(_panel(ref, 5))
    assert_close(spmm(a, Y), np.stack(
        [apply_ell(a, Y[:, j].contiguous()).numpy() for j in range(5)], 1))


def test_panel_vcycle_matches_reference_fused(ref, monkeypatch):
    """Against the reference's fused smoother on panels (Pallas, interpret
    mode)."""
    monkeypatch.setenv("REPRO_SMOOTH_PATH", "fused")
    R = _panel(ref, 3, seed=1)
    want = ref_vcycle.vcycle(ref["solver"].hierarchy, jnp.asarray(R))
    got = vcycle.vcycle(ref["port_hier"], torch.as_tensor(R))
    assert got.shape == R.shape
    assert_close(got, want)


def test_solve_many_matches_reference(ref):
    """Per-column iterations equal ``repro``'s masked panel PCG; a zero
    column is frozen at 0 iterations with relres 0."""
    B = _panel(ref, 4, seed=2)
    B[:, 2] = 0.0
    want = ref["solver"].solve_many(jnp.asarray(B))
    got = make_block_solve(ref["port_setup"])(ref["port_hier"],
                                              torch.as_tensor(B))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert int(got.iters[2]) == 0 and float(got.relres[2]) == 0.0
    assert np.all(got.x[:, 2].numpy() == 0.0)
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.health.status.numpy(),
                                  np.asarray(want.health.status))
    assert rel_err(got.x, want.x) <= SOLUTION


def test_solver_solve_many_matches_vector_solves(ref):
    """``GAMGSolver.solve_many`` on a whole port run: each column's
    iterations equal a dedicated vector solve; ``x0`` warm-starts."""
    prob = assemble_elasticity(ref["m"], path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=ref["coarse_size"],
                             coarsener="greedy")
    B = torch.as_tensor(_panel(ref, 3, seed=3))
    res = solver.solve_many(B)
    for j in range(3):
        v = solver.solve(B[:, j].contiguous())
        assert v.iters == int(res.iters[j]) == ref["iters"]
        assert rel_err(res.x[:, j], v.x) <= SOLUTION
    again = solver.solve_many(B, x0=res.x)
    assert int(again.iters.max()) <= 1


def test_block_pcg_history_pads_with_nan(ref):
    B = _panel(ref, 2, seed=4)
    B[:, 1] = 0.0
    res, hist = make_block_solve(ref["port_setup"], maxiter=50,
                                 record_history=True)(
        ref["port_hier"], torch.as_tensor(B))
    assert hist.shape == (50, 2)
    it = int(res.iters[0])
    assert torch.isfinite(hist[:it, 0]).all()
    assert torch.isnan(hist[it:, 0]).all() and torch.isnan(hist[:, 1]).all()
    assert float(hist[it - 1, 0]) == pytest.approx(
        float(res.relres[0]) * float(torch.linalg.vector_norm(
            torch.as_tensor(B[:, 0]))), rel=1e-12)


def test_pairs_recompute_matches_reference(ref, monkeypatch):
    """``recompute`` on the "pairs" SpGEMM path against the reference's
    recompute (its CPU default, the unfused reference path)."""
    a = ref["prob"].reassemble(1.3).data
    want = ref_gamg.recompute(ref["solver"].setup_data, a)
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "pairs")
    got = gamg.recompute(ref["port_setup"], torch.as_tensor(np.array(a)))
    for g, w in zip(got.levels, want.levels):
        assert_close(g.a_ell.data, w.a_ell.data)
        assert_close(g.dinv, w.dinv)
        assert_close(g.lam_max, w.lam_max)
    assert_close(got.coarse_chol, want.coarse_chol)


# ---------------------------------------------------------------------------
# The solve server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def m6():
    m, coarse_size, _, iters = CASES[0]
    prob = ref_assemble(m, path="host")
    setupd = ref_gamg.setup(prob.A, prob.B, coarse_size=coarse_size,
                            coarsener="greedy")
    levels, coarse = setup_to_numpy(setupd)
    return dict(prob=prob, setupd=setupd, iters=iters,
                port_setup=setup_from_numpy(levels, coarse,
                                            coarsener="greedy",
                                            device="cpu"),
                a=np.asarray(prob.A.data))


def _stream(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(count)]


def test_server_matches_reference_server(m6):
    """The same request stream through both servers: ids, buckets, stats,
    per-request iterations and solutions."""
    kw = dict(buckets=(1, 4), rtol=1e-8, maxiter=200)
    want_srv = RefServer(m6["setupd"], m6["prob"].A.data, **kw)
    got_srv = AMGSolveServer(m6["port_setup"], m6["a"], **kw)
    n = got_srv.n
    for burst, seed in ((1, 0), (3, 1), (5, 2)):
        rhs = _stream(n, burst, seed)
        want = want_srv.serve(rhs)
        got = got_srv.serve(rhs)
        assert [r.request_id for r in got] == [r.request_id for r in want]
        assert [r.k_bucket for r in got] == [r.k_bucket for r in want]
        assert [r.iters for r in got] == [r.iters for r in want]
        assert [r.status for r in got] == [r.status for r in want] == \
            ["ok"] * burst
        for g, w in zip(got, want):
            assert isinstance(g, SolveReport) and isinstance(g.x, np.ndarray)
            assert rel_err(g.x, w.x) <= SOLUTION
    a_new = m6["prob"].reassemble(1.2).data
    want_srv.update_operator(a_new)
    got_srv.update_operator(np.asarray(a_new))
    b = np.asarray(m6["prob"].b)
    got, want = got_srv.serve([b, b]), want_srv.serve([b, b])
    assert [r.iters for r in got] == [r.iters for r in want] == \
        [m6["iters"]] * 2
    assert got_srv.stats == want_srv.stats
    gs, ws = got_srv.snapshot(), want_srv.snapshot()
    for key in ("requests", "batches", "padded_columns",
                "padding_efficiency", "status", "solves_per_k"):
        assert gs[key] == ws[key], key


def test_server_chunks_over_the_largest_bucket(m6):
    srv = AMGSolveServer(m6["port_setup"], m6["a"], buckets=(2, 4))
    reps = srv.serve(_stream(srv.n, 11, 3))
    assert [r.k_bucket for r in reps] == [4] * 8 + [4] * 3
    assert [r.request_id for r in reps] == list(range(11))
    assert srv.stats["batches"] == 3 and srv.stats["padded_columns"] == 1
    assert all(r.converged and r.status == "ok" for r in reps)
    assert srv.metrics().padding_efficiency.value() == pytest.approx(11 / 12)
    assert srv._bucket_for(1) == 2 and srv._bucket_for(3) == 4
    for bad in (0, 5):
        with pytest.raises(ValueError):
            srv._bucket_for(bad)


@pytest.mark.parametrize("rhs,match", [
    ("shape", "shape"), ("nan", "non-finite"), ("text", "convert")])
def test_server_rejects_bad_requests(m6, rhs, match):
    srv = AMGSolveServer(m6["port_setup"], m6["a"], buckets=(1,))
    bad = {"shape": np.ones(srv.n + 1), "text": ["x"] * srv.n,
           "nan": np.full(srv.n, np.nan)}[rhs]
    with pytest.raises(ValueError, match=match):
        srv.submit(bad)
    assert srv.stats["rejected"] == 1
    assert srv.metrics().rejected.value() == 1
    assert srv.flush() == []


@pytest.mark.parametrize("kw,match", [
    (dict(buckets=()), "non-empty"), (dict(buckets=(0, 2)), "positive"),
    (dict(buckets=(2, 2)), "duplicate"),
    (dict(recover="retry"), "invalid recovery knob"),
    (dict(assembler="another mesh's"), "does not match")])
def test_server_refuses_bad_or_unported_options(m6, kw, match):
    if kw.get("assembler") == "another mesh's":
        kw = dict(assembler=assemble_elasticity(4, device="cpu").assembler)
    with pytest.raises(ValueError, match=match):
        AMGSolveServer(m6["port_setup"], m6["a"], **kw)


def test_server_records_history_when_asked(m6):
    srv = AMGSolveServer(m6["port_setup"], m6["a"], buckets=(2,),
                         maxiter=40, record_history=True)
    (rep,) = srv.serve(_stream(srv.n, 1, 4))
    assert rep.history.shape == (40,)
    assert np.isnan(rep.history[rep.iters:]).all()
    off = AMGSolveServer(m6["port_setup"], m6["a"], buckets=(2,))
    assert off.serve(_stream(off.n, 1, 4))[0].history is None


# ---------------------------------------------------------------------------
# Host metrics: a copy of the reference's, so the exports agree
# ---------------------------------------------------------------------------

def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a/total", help="count").inc(3)
    reg.counter("a/total").inc(2, labels={"k": 4})
    reg.gauge("b", help="gauge").set(0.25)
    h = reg.histogram("c/seconds", help="hist")
    for v in (1e-5, 3e-4, 0.02, 0.02, 7.0, 500.0):
        h.observe(v)
    reg.histogram("d", buckets=(1, 2, 4)).observe(3)
    return reg


def test_metrics_exports_match_reference():
    got, want = _fill(metrics), _fill(ref_metrics)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_jsonl(timestamp=1.0) == want.to_jsonl(timestamp=1.0)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        g = got.get("c/seconds").quantile(q)
        w = want.get("c/seconds").quantile(q)
        assert g == w or (math.isnan(g) and math.isnan(w))
    assert got.get("c/seconds").snapshot() == \
        want.get("c/seconds").snapshot()


def test_metrics_contracts():
    reg = metrics.MetricsRegistry()
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.counter("x").inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="quantile"):
        reg.histogram("h").quantile(1.5)
    assert math.isnan(reg.histogram("h").quantile(0.5))
    out = reg.measure("phase", lambda: torch.ones(3))
    reg.measure("phase", lambda: torch.ones(3))
    assert torch.equal(out, torch.ones(3))
    assert reg.get("phase/compile").snapshot()["count"] == 1
    assert reg.get("phase/steady").snapshot()["count"] == 1
    with reg.timer("t") as t:
        t.block({"a": (torch.zeros(2), [torch.ones(1)])})
    assert t.seconds is not None and t.seconds >= 0.0
