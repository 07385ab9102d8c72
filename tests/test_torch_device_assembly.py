"""The port's device assembly and coefficient hot loop against
``repro.fem`` and ``repro.core.gamg`` (JAX on the CPU): element blocks,
the value stream, the coefficient operator, the heterogeneous loop, the
solver's and the server's ``update_coefficients`` and the config's
``assembly`` field.  Floats at 1e-12 relative to the largest term
(``torch_helpers.rel_err``); iterations and levels exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.fem import assemble as ref_asm  # noqa: E402
from repro.fem.device_stiffness import \
    element_stiffness_blocks as ref_blocks  # noqa: E402
from repro.fem.hex_elasticity import element_quadrature  # noqa: E402

from repro_torch.configs.elasticity import ElasticityConfig  # noqa: E402
from repro_torch.core import gamg  # noqa: E402
from repro_torch.core.block_coo import set_values_coo, \
    set_values_coo_data  # noqa: E402
from repro_torch.fem.assemble import (  # noqa: E402
    assemble_elasticity,
    element_centroids,
    inclusion_fields,
)
from repro_torch.fem.device_stiffness import \
    element_stiffness_blocks  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402
from repro_torch.multirhs import AMGSolveServer  # noqa: E402

from torch_helpers import assert_close, rel_err  # noqa: E402

CONTRASTS = (1.0, 10.0, 100.0, 1000.0)
#: examples/heterogeneous.py at m=7: MIS, coarse_size=40, the reference's
#: levels and iterations per inclusion contrast
HETERO_ROWS, HETERO_ITERS = [882, 204], [9, 10, 14, 17]


def _fields(m, seed=0):
    """Smoothly varying per-element fields (as the reference's tests)."""
    from repro_torch.fem.hex_elasticity import hex_mesh
    c = element_centroids(hex_mesh(m))
    rng = np.random.default_rng(seed)
    E = 1.0 + 4.0 * c[:, 0] + 2.0 * c[:, 1] * c[:, 2] \
        + 0.1 * rng.random(len(c))
    nu = 0.20 + 0.15 * c[:, 2]
    return E, nu


@pytest.fixture(scope="module")
def m4():
    E, nu = _fields(4)
    return dict(E=E, nu=nu, ref=ref_asm.assemble_elasticity(4, E=E, nu=nu),
                port=assemble_elasticity(4, E=E, nu=nu, device="cpu"))


def test_element_stiffness_blocks_match_reference():
    Bq, wq = element_quadrature(1, 0.25)
    rng = np.random.default_rng(1)
    E, nu = 1.0 + rng.random(17), 0.1 + 0.3 * rng.random(17)
    want = np.asarray(ref_blocks(Bq, wq, E, nu))
    got = element_stiffness_blocks(torch.tensor(Bq), torch.tensor(wq),
                                   torch.tensor(E), torch.tensor(nu))
    assert got.shape == want.shape == (17, 24, 24)
    assert_close(got, want)
    assert torch.equal(got, got.transpose(1, 2))


def test_device_value_stream_and_operator_match_reference(m4):
    ref, port = m4["ref"], m4["port"]
    assert port.assembler is not None
    assert_close(port.values, np.asarray(ref.values))
    np.testing.assert_array_equal(port.A.indices, ref.A.indices)
    assert_close(port.A.data, np.asarray(ref.A.data))
    assert_close(port.E_field, m4["E"])
    assert_close(port.nu_field, m4["nu"])


@pytest.mark.parametrize("varying", [False, True], ids=["const", "varying"])
def test_port_device_matches_port_host(varying):
    E, nu = _fields(4) if varying else (1.0, 0.3)
    dev = assemble_elasticity(4, E=E, nu=nu, device="cpu")
    host = assemble_elasticity(4, E=E, nu=nu, path="host", device="cpu")
    assert dev.assembler is not None and host.assembler is None
    assert_close(dev.A.data, host.A.data)
    assert torch.equal(dev.b, host.b) and torch.equal(dev.B, host.B)


def test_inclusion_fields_and_centroids_are_bitwise_the_reference():
    from repro_torch.fem.hex_elasticity import hex_mesh
    from repro.fem.hex_elasticity import hex_mesh as ref_mesh
    np.testing.assert_array_equal(element_centroids(hex_mesh(5)),
                                  ref_asm.element_centroids(ref_mesh(5)))
    for kw in (dict(), dict(E_inclusion=1000.0, radius=0.45,
                            center=(0.5, 0.5, 0.5))):
        for got, want in zip(inclusion_fields(hex_mesh(7), **kw),
                             ref_asm.inclusion_fields(ref_mesh(7), **kw)):
            np.testing.assert_array_equal(got, want)


def test_set_values_coo_data_is_the_operator_payload(m4):
    port = m4["port"]
    data = set_values_coo_data(port.coo_plan, port.values)
    assert torch.equal(data, set_values_coo(port.coo_plan,
                                            port.values).data)
    from repro.core.block_coo import set_values_coo_data as ref_data
    assert_close(data, np.asarray(ref_data(m4["ref"].coo_plan,
                                           m4["ref"].values)))


def test_coefficient_operator_and_update_match_reference(m4):
    ref, port = m4["ref"], m4["port"]
    E, nu = inclusion_fields(port.mesh, E_inclusion=50.0)
    A0 = port.A.data.clone()
    got = port.coefficient_operator(E, nu)
    assert torch.equal(port.A.data, A0)       # pure: problem untouched
    assert_close(got.data, np.asarray(ref.coefficient_operator(E, nu).data))
    upd = port.update_coefficients(E, nu)
    assert upd is port.A and torch.equal(upd.data, got.data)
    assert_close(port.values, np.asarray(
        ref.assembler.value_stream(*ref.assembler.as_fields(E, nu))))
    np.testing.assert_array_equal(port.E_field.numpy(), E)
    np.testing.assert_array_equal(port.nu_field.numpy(), nu)


def test_const_coefficient_update_is_the_scaled_reassembly():
    prob = assemble_elasticity(4, device="cpu")
    assert_close(prob.coefficient_operator(2.5, 0.3).data,
                 prob.reassemble(2.5).data)


def test_host_path_refuses_coefficient_updates():
    host = assemble_elasticity(3, path="host", device="cpu")
    with pytest.raises(ValueError, match="device"):
        host.coefficient_operator(1.0, 0.3)
    with pytest.raises(ValueError, match="device"):
        host.update_coefficients(1.0, 0.3)
    with pytest.raises(ValueError, match="invalid assembly path"):
        assemble_elasticity(3, path="bogus", device="cpu")


@pytest.fixture(scope="module")
def hetero():
    """``examples/heterogeneous.py`` at m=7 through the port's defaults
    (device assembly, MIS, coarse_size=40)."""
    prob = assemble_elasticity(7, device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=40, rtol=1e-8,
                             maxiter=100)
    solver.bind_assembler(prob.assembler)
    runs = []
    for contrast in CONTRASTS:
        E, nu = inclusion_fields(prob.mesh, E_inclusion=contrast)
        solver.update_coefficients(E, nu)
        res = solver.solve(prob.b)
        runs.append((E, nu, res))
    return prob, solver, runs


def test_heterogeneous_loop_matches_reference(hetero):
    prob, solver, runs = hetero
    assert solver.setup_data.coarsener == "mis"
    assert solver.setup_data.stats["level_rows"] == HETERO_ROWS
    assert [r.iters for _, _, r in runs] == HETERO_ITERS
    assert all(int(r.health.status) == 0 and bool(r.converged)
               for _, _, r in runs)
    assert solver.n_recomputes == len(CONTRASTS)


def test_coefficient_hierarchy_matches_reference_recompute(hetero):
    """The port's coefficient recompute on the reference's m=7 setup
    (interop) against the reference's ``make_coeff_recompute``."""
    from repro_torch.interop import setup_from_numpy
    from torch_helpers import setup_to_numpy
    ref = ref_asm.assemble_elasticity(7)
    rs = ref_gamg.setup(ref.A, ref.B, coarse_size=40)
    levels, coarse = setup_to_numpy(rs)
    port_setup = setup_from_numpy(levels, coarse, device="cpu")
    E, nu, _ = hetero[2][2]
    want = ref_gamg.make_coeff_recompute(rs, ref.assembler)(
        *ref.assembler.as_fields(E, nu))
    got = gamg.make_coeff_recompute(port_setup, hetero[0].assembler)(
        *hetero[0].assembler.as_fields(E, nu))
    for g, w in zip(got.levels, want.levels):
        assert_close(g.a_ell.data, np.asarray(w.a_ell.data))
        assert_close(g.dinv, np.asarray(w.dinv))
        assert_close(g.lam_max, np.asarray(w.lam_max))
    assert_close(got.coarse_chol, np.asarray(want.coarse_chol))


def test_coeff_solve_is_update_then_solve(hetero):
    prob, solver, runs = hetero
    E, nu, res = runs[1]
    step = gamg.make_coeff_solve(solver.setup_data, prob.assembler)
    got = step(*prob.assembler.as_fields(E, nu), prob.b,
               torch.zeros_like(prob.b))
    assert got.iters == res.iters
    assert rel_err(got.x, res.x) <= 1e-12


def test_heterogeneous_update_loop_regression():
    """Twin of the reference's m=5 regression (coarse_size=30, MIS):
    iterations 10, 14, 17 over contrasts 10, 100, 1000; an f32 field is
    cast, not refused."""
    prob = assemble_elasticity(5, device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=30, maxiter=100)
    solver.bind_assembler(prob.assembler)
    iters = []
    for contrast in (10.0, 100.0, 1000.0):
        solver.update_coefficients(*inclusion_fields(
            prob.mesh, E_inclusion=contrast))
        res = solver.solve(prob.b)
        assert bool(res.converged)
        iters.append(res.iters)
    assert iters == [10, 14, 17]
    E32 = np.asarray(inclusion_fields(prob.mesh)[0], np.float32)
    solver.update_coefficients(E32, 0.3)
    assert solver.hierarchy.levels[0].a_ell.data.dtype == torch.float64


def test_solver_requires_bound_assembler():
    prob = assemble_elasticity(3, device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=30)
    with pytest.raises(ValueError, match="bind_assembler"):
        solver.update_coefficients(1.0, 0.3)


def test_bind_assembler_rejects_mismatched_plan():
    prob3 = assemble_elasticity(3, device="cpu")
    prob4 = assemble_elasticity(4, device="cpu")
    solver = gamg.GAMGSolver(prob4.A, prob4.B, coarse_size=30)
    with pytest.raises(ValueError, match="does not match"):
        solver.bind_assembler(prob3.assembler)
    assert solver.assembler is None
    with pytest.raises(ValueError, match="does not match"):
        gamg.make_coeff_solve(solver.setup_data, prob3.assembler)
    with pytest.raises(ValueError, match="does not match"):
        AMGSolveServer(solver.setup_data, prob4.A.data,
                       assembler=prob3.assembler)


def test_server_coefficient_updates():
    """The server's coefficient update refreshes the hierarchy as the
    solver's does, is timed and counted, and the next burst sees it."""
    prob = assemble_elasticity(4, device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=30)
    solver.bind_assembler(prob.assembler)
    no_asm = AMGSolveServer(solver.setup_data, prob.A.data, buckets=(1, 2))
    with pytest.raises(ValueError, match="assembler"):
        no_asm.update_coefficients(1.0, 0.3)
    srv = AMGSolveServer(solver.setup_data, prob.A.data, buckets=(1, 2),
                         assembler=prob.assembler)
    E, nu = inclusion_fields(prob.mesh, E_inclusion=100.0)
    srv.update_coefficients(E, nu)
    solver.update_coefficients(E, nu)
    for g, w in zip(srv.hierarchy.levels, solver.hierarchy.levels):
        assert torch.equal(g.a_ell.data, w.a_ell.data)
    assert srv.stats["coefficient_updates"] == 1
    assert srv.stats["recomputes"] == 1
    assert srv.metrics().coeff_update_seconds.snapshot()["count"] == 1
    b = prob.b.numpy()
    reps = srv.serve([b, 2 * b])
    want = solver.solve(prob.b)
    assert all(r.status == "ok" for r in reps)
    assert [r.iters for r in reps] == [want.iters] * 2
    assert rel_err(reps[0].x, want.x) <= 1e-9


def test_config_assembly_field_binds_the_assembler():
    prob, solver = ElasticityConfig(m=4, coarse_size=30).build(device="cpu")
    assert ElasticityConfig(m=4).assembly == "device"
    assert ElasticityConfig(m=4).coarsener == "greedy"
    assert prob.assembler is not None and solver.assembler is prob.assembler
    solver.update_coefficients(2.0, 0.3)
    host_prob, host_solver = ElasticityConfig(
        m=4, coarse_size=30, assembly="host").build(device="cpu")
    assert host_prob.assembler is None and host_solver.assembler is None
    assert_close(host_prob.A.data, prob.A.data)


def test_problem_from_numpy_rebuilds_a_device_path_problem():
    E, nu = _fields(4, seed=3)
    ref = ref_asm.assemble_elasticity(4, E=E, nu=nu)
    got = problem_from_numpy(4, values=np.asarray(ref.values),
                             b=np.asarray(ref.b), B=np.asarray(ref.B),
                             E_field=np.asarray(ref.E_field),
                             nu_field=np.asarray(ref.nu_field), device="cpu")
    np.testing.assert_array_equal(got.E_field.numpy(), E)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    E2, nu2 = inclusion_fields(got.mesh)
    assert_close(got.update_coefficients(E2, nu2).data,
                 np.asarray(ref.coefficient_operator(E2, nu2).data))
    with pytest.raises(ValueError, match="both"):
        problem_from_numpy(4, values=np.asarray(ref.values),
                           b=np.asarray(ref.b), B=np.asarray(ref.B),
                           E_field=E, device="cpu")
