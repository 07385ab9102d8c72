"""The port's blocked-COO assembly against ``repro.fem.assemble`` (host
path): problem, COO plan and hot reassembly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa

from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402

from torch_helpers import CASE_IDS, CASES  # noqa: E402


@pytest.fixture(scope="module", params=[c[0] for c in CASES], ids=CASE_IDS)
def pair(request):
    m = request.param
    return ref_assemble(m, path="host"), assemble_elasticity(m,
                                                             device="cpu")


def test_coo_plan_is_bitwise_the_reference(pair):
    ref, port = pair
    rp, pp = ref.coo_plan, port.coo_plan
    for name in ("indptr", "indices", "keep", "out_idx_sorted", "order"):
        np.testing.assert_array_equal(getattr(pp, name), getattr(rp, name))
    assert (pp.nbr, pp.nbc, pp.br, pp.bc, pp.nnzb, pp.n_input) == \
        (rp.nbr, rp.nbc, rp.br, rp.bc, rp.nnzb, rp.n_input)
    # the composed stream permutation and the segment bounds
    np.testing.assert_array_equal(pp.perm, rp.keep[rp.order])
    np.testing.assert_array_equal(
        np.diff(pp.offsets), np.bincount(rp.out_idx_sorted,
                                         minlength=rp.nnzb))


def test_problem_matches_reference(pair):
    ref, port = pair
    np.testing.assert_array_equal(port.A.indptr, ref.A.indptr)
    np.testing.assert_array_equal(port.A.indices, ref.A.indices)
    assert port.A.nbc == ref.A.nbc
    # the plain segment sum adds in the sorted segment_sum's order: bitwise
    np.testing.assert_array_equal(port.A.data.numpy(), np.asarray(ref.A.data))
    np.testing.assert_array_equal(port.b.numpy(), np.asarray(ref.b))
    np.testing.assert_array_equal(port.B.numpy(), np.asarray(ref.B))
    np.testing.assert_array_equal(port.values.numpy(),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(port.free_nodes, ref.free_nodes)


def test_reassembly_matches_reference(pair):
    ref, port = pair
    for scale in (1.1, 1.2):
        np.testing.assert_array_equal(port.reassemble(scale).data.numpy(),
                                      np.asarray(ref.reassemble(scale).data))


def test_problem_from_numpy_rebuilds_the_operator(pair):
    ref, _ = pair
    m = ref.mesh.n1
    got = problem_from_numpy(m, values=np.asarray(ref.values),
                             b=np.asarray(ref.b), B=np.asarray(ref.B),
                             device="cpu")
    np.testing.assert_array_equal(got.A.data.numpy(), np.asarray(ref.A.data))
    np.testing.assert_array_equal(got.A.indices, ref.A.indices)


def test_value_stream_shape_is_checked(pair):
    _, port = pair
    with pytest.raises(ValueError, match="value stream shape"):
        from repro_torch.core.block_coo import set_values_coo
        set_values_coo(port.coo_plan, port.values[:-1])
