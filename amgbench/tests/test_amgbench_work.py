"""The benchmark's own work counts against hand counts of a small
hierarchy, and the shapes it reads off a real one."""
import numpy as np
import pytest

import amgbench_cells  # noqa: F401  (puts the repo and src on the path)
from amgbench import generators, work

A = work.Op(nvalid=10, br=3, bc=3, nbr=4, nbc=4)
P = work.Op(nvalid=4, br=3, bc=6, nbr=4, nbc=1)
SHAPES = work.Shapes(levels=(work.Level(A=A, P=P, ap_pairs=10, ac_blocks=1),),
                     coarse_n=6, krylov=A, itemsize=8, krylov_itemsize=8,
                     coo_input=20, smoother_steps=2)


def test_cg_solve_hand_count():
    # per apply (8-byte payloads, 4-byte indices, one column):
    # A x      : 10*(72+4) + 12*8 in + 12*8 out            =   952 B, 180 F
    # smoother : 760 + dinv 4*9*8 + b, x, d in, x, d out 5*96 = 1528 B, 312 F
    # residual : 760 + 96 + 2*96                            =  1048 B, 180 F
    # P^T r    : 4*(144+4) + 12*8 + 6*8                     =   736 B, 144 F
    # x + P xc : 592 + 48 + 2*96                            =   832 B, 144 F
    # coarse   : 21*8 + 2*6*8                               =   264 B,  72 F
    # 2 iterations = 3 applies of A and 3 V-cycles of 4 smoother steps
    w = work.Work()
    work.cg_solve(w, SHAPES, iterations=2)
    assert w.bytes == 3 * 952 + 12 * 1528 + 3 * (1048 + 736 + 832 + 264)
    assert w.flops == 3 * 180 + 12 * 312 + 3 * (180 + 144 + 144 + 72)
    assert w.seconds == pytest.approx(w.bytes / work.PEAK_BYTES_PER_S)


def test_panel_and_update_hand_count():
    w = work.Work()
    work.cg_solve(w, SHAPES, iterations=0, k=16)
    # one apply of A on 16 columns: the matrix once, the vectors 16 times
    assert w.bytes > 16 * 2 * 96
    one = work.Work()
    work.apply_op(one, A, 16, 8)
    assert one.bytes == 760 + 16 * 96 + 16 * 96
    assert one.flops == 16 * 180
    w = work.Work()
    work.coefficient_update(w, SHAPES)
    # COO: 20 blocks (72 B + 4 B index) in, 10 blocks out; Galerkin: A
    # and P in, one 6x6 block out; A @ P pairs 10 of 3x3 @ 3x6
    assert w.bytes == 20 * 76 + 10 * 72 + 760 + 592 + 288
    assert w.flops == 20 * 9 + 2 * 10 * 3 * 3 * 6


def test_each_operation_priced_at_its_own_roofline():
    w = work.Work()
    w.add(3.35e12, 0.0)
    w.add(0.0, 67e12)
    assert w.seconds == pytest.approx(2.0)


def test_shapes_of_a_real_hierarchy():
    from repro_torch.configs.elasticity import ElasticityConfig
    prob, solver = ElasticityConfig(m=7, coarse_size=12).build("cpu")
    sd = solver.setup_data
    sh = generators.shapes(sd, solver.hierarchy, len(prob.coo_plan.perm))
    assert [lv.A.nvalid for lv in sh.levels] == sd.stats["level_nnzb"][:-1]
    assert [lv.P.nvalid for lv in sh.levels] == [ls.P.nnzb
                                                 for ls in sd.levels]
    assert sh.levels[-1].ac_blocks == sd.stats["level_nnzb"][-1]
    assert sh.coarse_n == sd.stats["level_rows"][-1]
    assert sh.coo_input == prob.mesh.n_elements * 64 - _clamped_pairs(prob)
    for ls, lv in zip(sd.levels, sh.levels):
        plen = np.diff(ls.P.indptr)
        assert lv.ap_pairs == int(plen[ls.A0.indices].sum())


def _clamped_pairs(prob):
    """Element node pairs with a clamped node on either side."""
    conn = prob.mesh.connectivity
    fixed = ~np.isin(conn, prob.free_nodes)
    either = fixed[:, :, None] | fixed[:, None, :]
    return int(either.sum())
