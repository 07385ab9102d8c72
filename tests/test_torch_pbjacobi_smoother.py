"""The port's ``smoother="pbjacobi"`` option (damped point-block Jacobi)
against ``repro``: ``apply_smoother`` on a real m=6 level, on the fused
and the reference paths, for a vector and a panel; then the whole
``GAMGSolver(..., smoother="pbjacobi")`` at m=6 with equal CG
iterations."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
import jax.numpy as jnp  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.core.vcycle import apply_smoother as ref_apply_smoother  # noqa
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.vcycle import apply_smoother  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy  # noqa: E402

from torch_helpers import assert_close, hierarchy_to_numpy, \
    rel_err  # noqa: E402

M, COARSE = 6, 100
SOLUTION = 1e-9     # whole-solve agreement (CG amplifies rounding)


@pytest.fixture(scope="module")
def ref():
    prob = ref_assemble(M, path="host")
    solver = ref_gamg.GAMGSolver(prob.A, prob.B, coarse_size=COARSE,
                                 coarsener="greedy", smoother="pbjacobi",
                                 rtol=1e-8, maxiter=200)
    a = prob.reassemble(1.1).data
    solver.update_operator(a)
    res = solver.solve(prob.b)
    return dict(prob=prob, solver=solver, iters=int(res.iters),
                x=np.asarray(res.x))


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "panel3"])
@pytest.mark.parametrize("path", ["fused", "reference"])
def test_apply_smoother_pbjacobi_matches_reference(ref, path, k):
    hier = ref["solver"].hierarchy
    levels, chol = hierarchy_to_numpy(hier)
    port_hier = hierarchy_from_numpy(levels, chol, device="cpu")
    n = ref["prob"].A.shape[0]
    shape = (n,) if k is None else (n, k)
    b = np.random.default_rng(66).standard_normal(shape)
    x0 = np.zeros(shape)
    got = apply_smoother(port_hier.levels[0], torch.as_tensor(b),
                         torch.as_tensor(x0), "pbjacobi", 2, path=path)
    for ref_path in ("reference", "fused"):
        want = ref_apply_smoother(hier.levels[0], jnp.asarray(b),
                                  jnp.asarray(x0), "pbjacobi", 2,
                                  path=ref_path)
        assert_close(got, want)


def test_pbjacobi_solver_matches_reference(ref):
    prob = assemble_elasticity(M, path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=COARSE,
                             coarsener="greedy", smoother="pbjacobi")
    assert solver.setup_data.smoother == "pbjacobi"
    solver.update_operator(prob.reassemble(1.1).data)
    res = solver.solve(prob.b)
    assert res.iters == ref["iters"]
    assert int(res.health.status) == 0
    assert rel_err(res.x, ref["x"]) <= SOLUTION
