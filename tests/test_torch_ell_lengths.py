"""Each ELL's row lengths, kept with its structure: ``ELLPlan.lengths``
and ``BlockELL.lengths`` count a row's valid slots (``mask.sum(1)``, the
slots that come first in the row) on every level of an m=8 hierarchy, in
the set-up's ELLs and in those ``interop`` loads; a recompute's
``build`` reuses the device copy made with the structure."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gamg  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import hierarchy_from_numpy  # noqa: E402

from torch_helpers import hierarchy_to_numpy  # noqa: E402


@pytest.fixture(scope="module")
def solved():
    prob = assemble_elasticity(8, path="host", device="cpu")
    solver = gamg.GAMGSolver(prob.A, prob.B, coarse_size=12,
                             coarsener="greedy")
    return prob, solver


def _holds_the_mask(lengths, mask):
    mask = torch.as_tensor(mask)
    lengths = torch.as_tensor(lengths)
    assert lengths.dtype == torch.int32
    assert torch.equal(lengths, mask.sum(1).to(torch.int32))
    assert torch.equal(mask, torch.arange(mask.shape[1]) < lengths[:, None])


def test_plan_lengths_count_the_mask(solved):
    _, solver = solved
    levels = solver.setup_data.levels
    assert [ls.A0.br for ls in levels] == [3, 6]
    for ls in levels:
        plan = ls.a_ell_plan
        _holds_the_mask(plan.lengths, plan.mask)
        np.testing.assert_array_equal(plan.lengths, np.diff(ls.A0.indptr))
        _holds_the_mask(ls.P.ell_plan().lengths, ls.P.ell_plan().mask)


def test_built_ells_carry_the_lengths(solved):
    _, solver = solved
    for lv in solver.hierarchy.levels:
        for ell in (lv.a_ell, lv.p_ell):
            assert ell.lengths.device == ell.data.device
            _holds_the_mask(ell.lengths, ell.mask)


def test_interop_ells_take_lengths_from_the_mask(solved):
    _, solver = solved
    levels, chol = hierarchy_to_numpy(solver.hierarchy)
    got = hierarchy_from_numpy(levels, chol, device="cpu")
    for lv, want in zip(got.levels, solver.hierarchy.levels):
        for ell, ref in ((lv.a_ell, want.a_ell), (lv.p_ell, want.p_ell)):
            _holds_the_mask(ell.lengths, ell.mask)
            assert torch.equal(ell.lengths, ref.lengths)


def test_interop_refuses_a_mask_with_holes(solved):
    _, solver = solved
    levels, chol = hierarchy_to_numpy(solver.hierarchy)
    mask = levels[0]["a_ell"]["mask"].copy()
    mask[0, 0] = False
    levels[0]["a_ell"] = dict(levels[0]["a_ell"], mask=mask)
    with pytest.raises(ValueError, match="valid slots must come first"):
        hierarchy_from_numpy(levels, chol, device="cpu")


def test_recompute_reuses_the_device_lengths(solved):
    """A recompute's ``build`` adds no copy: every level's lengths are the
    tensor the set-up uploaded once."""
    prob, solver = solved
    old = [lv.a_ell for lv in solver.hierarchy.levels]
    solver.update_operator(prob.A.data * 1.25)
    for lv, was in zip(solver.hierarchy.levels, old):
        assert lv.a_ell.lengths is was.lengths
        assert not torch.equal(lv.a_ell.data, was.data)
