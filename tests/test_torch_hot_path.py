"""The port's hot path against ``repro``: ``recompute``, ``vcycle`` and
``pcg`` on interop-converted reference setups and hierarchies (hot-path
parity apart from cold-setup parity), then the whole slice — assembly,
setup and 3 hot steps — against ``repro.core.gamg.GAMGSolver``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core import vcycle as ref_vcycle  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core import vcycle  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy, \
    setup_from_numpy  # noqa: E402

from torch_helpers import CASE_IDS, CASES, assert_close, \
    hierarchy_to_numpy, rel_err, setup_to_numpy, to_np  # noqa: E402

SOLUTION = 1e-9     # whole-solve agreement (CG amplifies rounding)


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def ref(request):
    """The reference problem, its default solver (3 hot steps recorded) and
    the interop-converted setup."""
    m, coarse_size, rows, iters = request.param
    prob = ref_assemble(m, path="host")
    solver = ref_gamg.GAMGSolver(prob.A, prob.B, coarse_size=coarse_size,
                                 coarsener="greedy", rtol=1e-8, maxiter=200)
    steps = []
    for step in range(3):
        a = prob.reassemble(1.0 + 0.1 * step)
        solver.update_operator(a.data)
        res = solver.solve(prob.b)
        steps.append((int(res.iters), np.asarray(res.x)))
    levels, coarse = setup_to_numpy(solver.setup_data)
    port_setup = setup_from_numpy(levels, coarse, coarsener="greedy",
                                  device="cpu")
    return dict(m=m, coarse_size=coarse_size, rows=rows, iters=iters,
                prob=prob, solver=solver, steps=steps, port_setup=port_setup)


def test_recompute_matches_reference(ref):
    a = ref["prob"].reassemble(1.3).data
    want = ref_gamg.recompute(ref["solver"].setup_data, a)
    got = gamg.recompute(ref["port_setup"], torch.as_tensor(np.array(a)))
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        assert_close(g.a_ell.data, w.a_ell.data)
        assert_close(g.dinv, w.dinv)
        assert_close(g.lam_max, w.lam_max)
        np.testing.assert_array_equal(g.a_ell.indices.numpy(),
                                      np.asarray(w.a_ell.indices))
    assert_close(got.coarse_chol, want.coarse_chol)


def test_vcycle_matches_reference_fused(ref, monkeypatch):
    """Against the reference's fused smoother (Pallas, interpret mode)."""
    monkeypatch.setenv("REPRO_SMOOTH_PATH", "fused")
    hier = ref["solver"].hierarchy
    levels, chol = hierarchy_to_numpy(hier)
    port_hier = hierarchy_from_numpy(levels, chol, device="cpu")
    r = np.random.default_rng(ref["m"]).standard_normal(
        ref["prob"].A.shape[0])
    want = ref_vcycle.vcycle(hier, jnp.asarray(r))
    got = vcycle.vcycle(port_hier, torch.as_tensor(r))
    assert_close(got, want)


def test_pcg_matches_reference(ref):
    hier = ref["solver"].hierarchy
    levels, chol = hierarchy_to_numpy(hier)
    port_hier = hierarchy_from_numpy(levels, chol, device="cpu")
    b = ref["prob"].b
    want = ref_gamg.hier_solve(ref["solver"].setup_data, hier, b)
    got = gamg.hier_solve(ref["port_setup"], port_hier,
                          torch.as_tensor(np.array(b)))
    assert got.iters == int(want.iters)
    assert bool(got.converged) and bool(want.converged)
    assert int(got.health.status) == 0
    assert rel_err(got.x, want.x) <= SOLUTION


def test_whole_slice_matches_reference(ref):
    prob = assemble_elasticity(ref["m"], path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=ref["coarse_size"],
                             coarsener="greedy")
    assert solver.setup_data.stats["level_rows"] == ref["rows"]
    for step, (iters, x) in enumerate(ref["steps"]):
        a = prob.reassemble(1.0 + 0.1 * step)
        solver.update_operator(a.data)
        res = solver.solve(prob.b)
        assert res.iters == iters == ref["iters"]
        assert int(res.health.status) == 0
        assert rel_err(res.x, x) <= SOLUTION
    assert solver.n_recomputes == 3


def test_warm_start_and_health(ref):
    """``x0`` at the solution converges in zero iterations; a zero rhs
    reports converged with relres 0 (the ``finfo.tiny`` floor)."""
    prob = assemble_elasticity(ref["m"], path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=ref["coarse_size"],
                             coarsener="greedy")
    res = solver.solve(prob.b)
    again = solver.solve(prob.b, x0=res.x)
    assert again.iters <= 1
    zero = solver.solve(torch.zeros_like(prob.b))
    assert zero.iters == 0 and bool(zero.converged)
    assert float(zero.relres) == 0.0
    assert to_np(zero.x).max() == 0.0
