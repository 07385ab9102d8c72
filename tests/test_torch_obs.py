"""The port's observability layer against ``repro.obs`` (JAX on the CPU):
the knob, the off-mode op sequence, spans and counters bitwise the off
solve, the ``CycleTally`` field by field, the traffic model exactly, and
the server's history default.  Both sides build their own m=4 setup with
the reference's defaults (device assembly, the MIS coarsener), which the
port reproduces bitwise."""
import contextlib
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.multirhs.block_krylov import make_block_solve as \
    ref_make_block_solve  # noqa: E402
from repro.obs import model as ref_model  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import gamg  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.kernels.backend import resolve_obs  # noqa: E402
from repro_torch.multirhs import AMGSolveServer  # noqa: E402
from repro_torch.multirhs.block_krylov import make_block_solve  # noqa
from repro_torch.obs import model  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

from torch_helpers import assert_close  # noqa: E402

#: the aten op sequence of ``make_solve(...)(hier, b)`` on the m=4,
#: ``coarse_size=40`` case below, recorded on the tree before the
#: observability layer existed (op count, SHA-256 of the newline-joined
#: op names)
PRE_OBS_OPS = (3032, "d33b200651aaad1ad8e6f6cc9b0eb6008f0092f4a916fe24a9"
                     "81977b9a62c8b5")

#: coarse_size 40 pins two levels (one smoothed + the coarse grid), 4
#: three
SIZES = [40, 4]


class OpLog(TorchDispatchMode):
    """The aten ops dispatched inside the block, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with OpLog() as log:
        out = fn()
    return out, log.ops


@pytest.fixture(scope="module")
def probs():
    return assemble_elasticity(4, device="cpu"), ref_assemble(4)


_CASES = {}


def _case(probs, cs: int) -> dict:
    """Port and reference setups and hierarchies at one coarse size (built
    once per module)."""
    if cs not in _CASES:
        prob, rprob = probs
        sd = gamg.setup(prob.A, prob.B, coarse_size=cs, precision="f64")
        rsd = ref_gamg.setup(rprob.A, rprob.B, coarse_size=cs,
                             precision="f64")
        assert sd.stats["level_rows"] == list(rsd.stats["level_rows"])
        _CASES[cs] = dict(prob=prob, rprob=rprob, sd=sd, rsd=rsd,
                          hier=gamg.make_recompute(sd)(prob.A.data),
                          rhier=ref_gamg.make_recompute(rsd)(rprob.A.data))
    return _CASES[cs]


@pytest.fixture(scope="module", params=SIZES, ids=["cs40", "cs4"])
def case(request, probs):
    return _case(probs, request.param)


@pytest.fixture(scope="module")
def two(probs):
    """The two-level case."""
    return _case(probs, 40)


@pytest.fixture(scope="module")
def three(probs):
    """The three-level case."""
    case = _case(probs, 4)
    assert case["sd"].n_levels == 3
    return case


def _panel(b, k):
    scale = (1.0, 2.0, -0.5, 3.0)[:k]
    return torch.stack([s * b for s in scale], 1)


# ---------------------------------------------------------------------------
# The knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw,want", [
    ("off", "off"), ("0", "off"), ("", "off"), ("none", "off"),
    ("spans", "spans"), ("1", "spans"), ("ON", "spans"),
    ("counters", "counters"), ("Counters", "counters")])
def test_resolve_obs_accepts_the_references_strings(raw, want):
    from repro.kernels.backend import resolve_obs as ref_resolve
    assert resolve_obs(raw) == ref_resolve(raw) == want


def test_resolve_obs_env_and_errors(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_OBS", raising=False)
    monkeypatch.setenv("REPRO_OBS", "counters")
    assert resolve_obs() == "off"           # the reference's knob
    monkeypatch.setenv("REPRO_TORCH_OBS", "spans")
    assert resolve_obs() == "spans" and trace.resolve() == "spans"
    with pytest.raises(ValueError, match="invalid observability mode"):
        resolve_obs("verbose")


def test_use_scope_takes_precedence_over_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_OBS", "counters")
    with trace.use("off"):
        assert not trace.spans_enabled()
        with trace.use("spans"):
            assert trace.spans_enabled() and not trace.counters_enabled()
        assert trace.resolve() == "off"
    assert trace.counters_enabled()
    monkeypatch.setenv("REPRO_TORCH_OBS", "off")
    assert isinstance(trace.span("x"), type(trace.span("y")))
    assert not trace.spans_enabled()


# ---------------------------------------------------------------------------
# Off costs nothing; spans and counters change no bit
# ---------------------------------------------------------------------------

def test_off_dispatches_the_pre_obs_op_sequence(two):
    case = two
    b = case["prob"].b
    solve = gamg.make_solve(case["sd"], rtol=1e-8, maxiter=100, obs="off")
    solve(case["hier"], b)
    res, ops = _ops(lambda: solve(case["hier"], b))
    digest = hashlib.sha256("\n".join(ops).encode()).hexdigest()
    assert (len(ops), digest) == PRE_OBS_OPS
    assert res.counters is None


def test_spans_add_no_aten_op_and_counters_only_add(case):
    b, hier, sd = case["prob"].b, case["hier"], case["sd"]
    kw = dict(rtol=1e-8, maxiter=100)
    gamg.make_solve(sd, **kw)(hier, b)      # the index arrays' first copy
    r_off, off = _ops(lambda: gamg.make_solve(sd, obs="off", **kw)(hier, b))
    r_sp, spans = _ops(lambda: gamg.make_solve(sd, obs="spans", **kw)(
        hier, b))
    r_ct, cnt = _ops(lambda: gamg.make_solve(sd, obs="counters", **kw)(
        hier, b))
    # a range is a profiler op of its own, not an aten op
    ranges = [op for op in spans if op.startswith("profiler.")]
    assert ranges and all("record_function" in op for op in ranges)
    assert [op for op in spans if not op.startswith("profiler.")] == off
    cnt = [op for op in cnt if not op.startswith("profiler.")]
    it = iter(cnt)                   # off is a subsequence of counters
    assert all(op in it for op in off)
    assert len(cnt) > len(off)
    for r in (r_sp, r_ct):
        assert torch.equal(r.x, r_off.x) and r.iters == r_off.iters
        assert torch.equal(r.relres, r_off.relres)


def test_panel_spans_and_counters_bitwise_off(three):
    case = three
    B = _panel(case["prob"].b, 3)
    outs = {mode: make_block_solve(case["sd"], rtol=1e-8, maxiter=100,
                                   obs=mode)(case["hier"], B)
            for mode in trace.MODES}
    for mode in ("spans", "counters"):
        assert torch.equal(outs[mode].x, outs["off"].x)
        assert torch.equal(outs[mode].iters, outs["off"].iters)
    assert outs["off"].counters is None and outs["spans"].counters is None


def test_mode_binds_when_the_closure_is_built(case):
    """A closure built under off stays off inside a counters scope, and
    one built under counters stays counted outside it, as the
    reference's traces keep their mode."""
    b, hier, sd = case["prob"].b, case["hier"], case["sd"]
    with trace.use("off"):
        plain = gamg.make_solve(sd, maxiter=100)
    with trace.use("counters"):
        counted = gamg.make_solve(sd, maxiter=100)
        assert plain(hier, b).counters is None
    assert counted(hier, b).counters is not None


def _span_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_spans_name_every_stage(three):
    case = three
    sd, prob = case["sd"], case["prob"]
    nl = sd.n_levels - 1

    def step():
        hier = gamg.make_recompute(sd)(prob.A.data)
        return gamg.make_solve(sd, maxiter=100)(hier, prob.b)

    with trace.use("spans"):
        names = _span_names(step)
    want = {"vcycle/coarse", "recompute/coarse_chol", "apply_ell_t",
            "kernels/block_spmv", "kernels/fused_smoother",
            "kernels/block_seg_sum", "kernels/fused_pair_gemm"}
    for li in range(nl):
        want |= {f"vcycle/level{li}/{s}" for s in
                 ("smooth", "restrict", "prolong")}
        want |= {f"recompute/level{li}/{s}" for s in
                 ("smoother_data", "ptap")}
    assert want <= names, sorted(want - names)
    # the operator applies run inside their kernel's range alone
    assert not names & {"spmv_ell", "spmm_ell"}
    with trace.use("off"):
        names_off = _span_names(step)
    assert not {n for n in names_off if n.startswith(("vcycle/",
                                                      "kernels/"))}


def test_traced_closure_binds_the_mode_at_its_first_call(two):
    case = two
    sd, prob = case["sd"], case["prob"]
    with trace.use("off"):
        rec = gamg.make_recompute(sd)
        rec(prob.A.data)
    with trace.use("spans"):
        names = _span_names(lambda: rec(prob.A.data))
    assert not {n for n in names if n.startswith("recompute/")}


# ---------------------------------------------------------------------------
# The tally against the reference's
# ---------------------------------------------------------------------------

def _tally_np(t):
    return {f: np.asarray(t.cpu() if hasattr(t, "cpu") else t).tolist()
            for f, t in t._asdict().items()}


def _check_tally(got, want):
    g, w = _tally_np(got), _tally_np(want)
    for f in ("level_visits", "smoother_applies", "coarse_solves",
              "operator_applies", "precond_applies"):
        assert g[f] == w[f], (f, g[f], w[f])
    assert g["modeled_bytes"] == w["modeled_bytes"]
    assert got.modeled_bytes.dtype == torch.float64
    assert got.level_visits.dtype == torch.int32


def test_vector_tally_matches_reference(case):
    res = gamg.make_solve(case["sd"], rtol=1e-8, maxiter=100,
                          obs="counters")(case["hier"], case["prob"].b)
    want = ref_gamg.make_solve(case["rsd"], rtol=1e-8, maxiter=100,
                               obs="counters")(case["rhier"],
                                               case["rprob"].b)
    assert res.iters == int(want.iters)
    _check_tally(res.counters, want.counters)
    cycles = res.iters + 1           # the reference's analytic counts
    nl = case["sd"].n_levels - 1
    assert res.counters.level_visits.tolist() == [cycles] * nl
    assert res.counters.smoother_applies.tolist() == [2 * cycles] * nl
    assert trace.describe_tally(res.counters) == \
        ref_trace.describe_tally(want.counters)
    assert_close(res.x, want.x)


def test_panel_tally_matches_reference(case):
    B = _panel(case["prob"].b, 3)
    RB = jnp.stack([s * case["rprob"].b for s in (1.0, 2.0, -0.5)], 1)
    res = make_block_solve(case["sd"], rtol=1e-8, maxiter=100,
                           obs="counters")(case["hier"], B)
    want = ref_make_block_solve(case["rsd"], rtol=1e-8, maxiter=100,
                                obs="counters")(case["rhier"], RB)
    assert res.iters.tolist() == np.asarray(want.iters).tolist()
    _check_tally(res.counters, want.counters)
    assert int(res.counters.precond_applies) == int(res.iters.max()) + 1


def test_solver_front_door_counts(probs):
    prob = probs[0]
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=40,
                             maxiter=100, obs="counters")
    res = solver.solve(prob.b)
    assert int(res.counters.precond_applies) == res.iters + 1
    many = solver.solve_many(_panel(prob.b, 2))
    assert int(many.counters.precond_applies) == int(many.iters.max()) + 1
    assert gamg.GAMGSolver(prob.A, prob.B, coarse_size=40).solve(
        prob.b).counters is None


def test_zero_tally_and_attach_model_bytes():
    t = trace.zero_tally(3, "cpu")
    assert t.level_visits.shape == (2,) and t.level_visits.dtype == \
        torch.int32
    assert trace.zero_tally(1, "cpu").level_visits.shape == (0,)
    t = t._replace(precond_applies=t.precond_applies + 5)
    assert float(trace.attach_model_bytes(t, 1.5e6).modeled_bytes) == 7.5e6
    assert trace.bump(t.level_visits, 1).tolist() == [0, 1]
    assert t.level_visits.tolist() == [0, 0]          # a new tensor


# ---------------------------------------------------------------------------
# The traffic model against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored(probs):
    prob, rprob = probs
    return (gamg.setup(prob.A, prob.B, coarse_size=8, restriction="stored"),
            ref_gamg.setup(rprob.A, rprob.B, coarse_size=8,
                           restriction="stored"))


@pytest.mark.parametrize("itemsize", [8, 4, 2])
@pytest.mark.parametrize("restriction", ["transpose_free", "stored"])
def test_traffic_model_matches_reference(case, stored, itemsize,
                                         restriction):
    sd, rsd = (case["sd"], case["rsd"]) if restriction == \
        "transpose_free" else stored
    for scalar in (False, True):
        assert model.vcycle_traffic(sd, itemsize, scalar) == \
            ref_model.vcycle_traffic(rsd, itemsize, scalar)
    assert model.hierarchy_storage_bytes(sd, itemsize) == \
        ref_model.hierarchy_storage_bytes(rsd, itemsize)


def test_value_itemsize_matches_reference():
    for d in ("f64", "f32", "bf16", "float64", "float32", np.float16):
        assert model.value_itemsize(d) == ref_model.value_itemsize(d)
    assert model.value_itemsize(torch.bfloat16) == 2
    assert model.value_itemsize(torch.float64) == 8


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_modeled_bytes_at_reduced_precision(probs, precision):
    """Each cycle's modeled bytes at the policy's itemsize equal the
    reference's; at f32 the whole tally does (bf16 rounds differently, so
    its iteration count may differ by one)."""
    prob, rprob = probs
    sd = gamg.setup(prob.A, prob.B, coarse_size=40, precision=precision)
    rsd = ref_gamg.setup(rprob.A, rprob.B, coarse_size=40,
                         precision=precision)
    res = gamg.make_solve(sd, maxiter=100, obs="counters")(
        gamg.make_recompute(sd)(prob.A.data), prob.b)
    want = ref_gamg.make_solve(rsd, maxiter=100, obs="counters")(
        ref_gamg.make_recompute(rsd)(rprob.A.data), rprob.b)
    per_cycle = float(res.counters.modeled_bytes) \
        / int(res.counters.precond_applies)
    assert per_cycle == float(want.counters.modeled_bytes) \
        / int(want.counters.precond_applies)
    assert per_cycle == model.vcycle_traffic(
        sd, model.value_itemsize(precision))["total"]
    if precision == "f32":
        assert res.iters == int(want.iters)
        _check_tally(res.counters, want.counters)


# ---------------------------------------------------------------------------
# The server's history default
# ---------------------------------------------------------------------------

def test_server_record_history_follows_the_knob(two, monkeypatch):
    sd, prob = two["sd"], two["prob"]
    monkeypatch.delenv("REPRO_TORCH_OBS", raising=False)
    assert not AMGSolveServer(sd, prob.A.data)._record_history
    with trace.use("spans"):
        srv = AMGSolveServer(sd, prob.A.data, buckets=(2,), maxiter=100)
    assert srv._record_history
    rep = srv.serve([prob.b.numpy()])[0]
    assert rep.history is not None and rep.history.shape == (100,)
    assert np.isfinite(rep.history[:rep.iters]).all()
    assert np.isnan(rep.history[rep.iters:]).all()
    monkeypatch.setenv("REPRO_TORCH_OBS", "counters")
    assert AMGSolveServer(sd, prob.A.data)._record_history
    assert not AMGSolveServer(sd, prob.A.data,
                              record_history=False)._record_history
    monkeypatch.setenv("REPRO_OBS", "spans")
    monkeypatch.setenv("REPRO_TORCH_OBS", "off")
    assert not AMGSolveServer(sd, prob.A.data)._record_history


# ---------------------------------------------------------------------------
# The host ranges: recorded whenever a profiler records, else free
# ---------------------------------------------------------------------------

#: host reads the CPU makes and the card does not, by a name on their
#: profiler parent chain: the CPU's error check of ``cholesky_solve`` (on
#: CUDA one cuSOLVER solve, no check), the plain ``block_seg_sum``'s
#: segment count (the card runs the kernel) and the coarse retry jitter
#: (a host tensor on either device)
CPU_ONLY_READS = ("aten::cholesky_solve", "block_seg_sum_ref",
                  "coarse_retry_scale")

SERVER_CHILDREN = ["server/flush/pack", "server/flush/upload",
                   "server/flush/solve", "server/flush/fetch",
                   "server/flush/report"]


@pytest.fixture(scope="module")
def coeff_solver(probs):
    from repro_torch.fem.assemble import inclusion_fields
    prob = probs[0]
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=40, maxiter=100)
    solver.bind_assembler(prob.assembler)
    fields = inclusion_fields(prob.mesh, E_inclusion=10.0)
    solver.update_coefficients(*fields)
    solver.solve(prob.b)
    return solver, fields


def _served(two, k, buckets):
    sd, prob = two["sd"], two["prob"]
    srv = AMGSolveServer(sd, prob.A.data, buckets=buckets, maxiter=100)
    rhs = [s * prob.b.numpy() for s in (1.0, 2.0, -0.5, 3.0)[:k]]
    srv.serve(rhs)
    return srv, rhs


def _profiled(fn, stack=False):
    with profile(activities=[ProfilerActivity.CPU], with_stack=stack) as p:
        fn()
    return sorted(p.events(), key=lambda e: e.time_range.start)


def _within(inner, outer) -> bool:
    return outer.time_range.start <= inner.time_range.start and \
        inner.time_range.end <= outer.time_range.end


def _chain(e) -> list:
    names = []
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return names


@pytest.mark.parametrize("unit", ["coefficient_step", "served_panel"])
def test_every_host_read_is_in_a_sync_range(unit, coeff_solver, two, probs):
    prob = probs[0]
    if unit == "coefficient_step":
        solver, fields = coeff_solver

        def run():
            solver.update_coefficients(*fields)
            solver.solve(prob.b)
    else:
        srv, rhs = _served(two, 3, (4,))

        def run():
            srv.serve(rhs)
    events = _profiled(run, stack=True)
    syncs = [e for e in events if e.name.startswith("sync/")]
    reads = [e for e in events if e.name == "aten::_local_scalar_dense"]
    loose = [_chain(e) for e in reads
             if not any(_within(e, s) for s in syncs)]
    assert syncs and len(reads) > len(loose)
    assert all(any(n.endswith(CPU_ONLY_READS) for n in c) for c in loose), \
        [c[:6] for c in loose if not any(n.endswith(CPU_ONLY_READS)
                                         for n in c)]
    names = {e.name for e in syncs}
    if unit == "coefficient_step":
        assert names == {"sync/cg_exit", "sync/coarse_chol_info",
                         "sync/diag_inv"}
        assert sum(e.name == "sync/cg_exit" for e in syncs) == \
            solver.solve(prob.b).iters + 1
    else:
        assert names == {"sync/block_cg_exit", "sync/panel_upload"}


def test_served_round_ranges_nest_in_order(two):
    """One ``server/submit`` a request; a ``server/flush`` a panel holding
    its five children once each, in order, the upload's sync inside the
    upload."""
    srv, rhs = _served(two, 3, (2,))          # two panels: 2 + 1 columns
    wall = srv.metrics().solve_wall
    before = wall.snapshot()["sum"]
    events = _profiled(lambda: srv.serve(rhs))
    timed = wall.snapshot()["sum"] - before
    server = [e for e in events if e.name.startswith(("server/",
                                                      "sync/panel"))]
    assert [e.name for e in server if e.name == "server/submit"] == \
        ["server/submit"] * 3
    flushes = [e for e in server if e.name == "server/flush"]
    assert len(flushes) == 2
    for f in flushes:
        inside = [e.name for e in server if e is not f and _within(e, f)]
        assert inside == SERVER_CHILDREN[:2] + ["sync/panel_upload"] + \
            SERVER_CHILDREN[2:]
    upload = [e for e in server if e.name == "server/flush/upload"]
    sync = [e for e in server if e.name == "sync/panel_upload"]
    assert all(_within(s, u) for s, u in zip(sync, upload))
    # pack, upload, solve and fetch cover what solve_wall_seconds times
    covered = 1e-6 * sum(e.time_range.elapsed_us() for e in server
                         if e.name in SERVER_CHILDREN[:4])
    assert covered == pytest.approx(timed, rel=0.01, abs=2e-4)


def test_host_span_is_free_without_a_profiler(two):
    assert isinstance(trace.host_span("sync/x"), contextlib.nullcontext)
    srv, rhs = _served(two, 3, (4,))
    for b in rhs:
        srv.submit(b)
    reports, ops = _ops(srv.flush)
    assert len(reports) == 3
    assert not [op for op in ops if op.startswith("profiler.")]
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(trace.host_span("sync/x"),
                              contextlib.nullcontext)


@pytest.mark.parametrize("mode,recorded", [("spans", True), ("off", False)])
def test_assembly_ranges_follow_the_knob(coeff_solver, mode, recorded):
    solver, fields = coeff_solver
    assembler = solver.assembler
    with trace.use(mode):
        names = _span_names(lambda: assembler.coo_data(
            *assembler.as_fields(*fields)))
    both = {"assemble/value_stream", "assemble/scatter"}
    assert names & both == (both if recorded else set())
