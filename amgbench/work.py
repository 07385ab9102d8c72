"""The least time an H100 needs for the sparse work of a window.

The work is reckoned from the operators, not from the kernels that apply
them, so it reads the same whatever implements it:

* every apply of a level operator A, a prolongator P or its transpose, and
  every smoother step, of each V-cycle and CG iteration;
* every Galerkin product and the COO scatter-sum of each coefficient
  update.

Each operation is priced by its own roofline: every input byte read once,
every output byte written once, an ELL product over its stored (valid)
blocks only with a 4-byte column index each, and the larger of bytes over
the peak bandwidth and flops over the peak rate.  The peaks are NVIDIA's
published figures for the SXM H100 (3.35 TB/s of HBM3; 67 TFLOP/s fp64 on
the tensor cores, the highest fp64 rate the chip offers, and also its
fp32 rate outside them).  The Galerkin flops count the ``A @ P`` pairs
only, so they are a lower bound; the bytes bound those products anyway.
"""
from __future__ import annotations

import dataclasses

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
INDEX_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Op:
    """A sparse operator's shape: stored blocks, block and grid sizes."""
    nvalid: int
    br: int
    bc: int
    nbr: int
    nbc: int


@dataclasses.dataclass(frozen=True)
class Level:
    A: Op
    P: Op
    ap_pairs: int          # block pairs of the Galerkin product A @ P
    ac_blocks: int         # stored blocks of its result P^T A P


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the work counts need of one hierarchy."""
    levels: tuple          # of Level, finest first
    coarse_n: int          # rows of the dense coarse factor
    krylov: Op             # the operator CG applies (the finest)
    itemsize: int          # hierarchy payload bytes
    krylov_itemsize: int
    coo_input: int         # blocks of the assembly's value stream
    smoother_steps: int    # fused steps of one smoother application


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0
    seconds: float = 0.0

    def add(self, nbytes: float, flops: float, times: float = 1.0):
        self.bytes += times * nbytes
        self.flops += times * flops
        self.seconds += times * max(nbytes / PEAK_BYTES_PER_S,
                                    flops / PEAK_FLOPS)


def _matrix_bytes(op: Op, s: int) -> int:
    return op.nvalid * (op.br * op.bc * s + INDEX_BYTES)


def apply_op(w: Work, op: Op, k: int, s: int, extra_vectors: int = 0,
             times: float = 1.0, transpose: bool = False) -> None:
    """``y = op @ x`` (or ``op^T @ x``) on ``k`` columns; ``extra_vectors``
    more output-sized vectors read (a right-hand side, an iterate)."""
    n_in, n_out = (op.nbc * op.bc, op.nbr * op.br)
    if transpose:
        n_in, n_out = n_out, n_in
    nbytes = (_matrix_bytes(op, s) + n_in * k * s
              + (1 + extra_vectors) * n_out * k * s)
    w.add(nbytes, 2.0 * op.nvalid * op.br * op.bc * k, times)


def smoother_step(w: Work, A: Op, k: int, s: int, times: float) -> None:
    """``d' = c1 d + c2 D^-1 (b - A x); x' = x + d'``: A and the inverted
    diagonal blocks read, b, x and d read, x and d written."""
    n = A.nbr * A.br
    nbytes = (_matrix_bytes(A, s) + A.nbr * A.br * A.br * s
              + 5 * n * k * s)
    flops = 2.0 * (A.nvalid * A.br * A.bc + A.nbr * A.br * A.br) * k \
        + 5.0 * n * k
    w.add(nbytes, flops, times)


def vcycles(w: Work, sh: Shapes, k: int, cycles: float) -> None:
    """``cycles`` V-cycles on ``k`` columns: per level the pre- and
    post-smoothing steps, the residual, the restriction and the
    prolongation; then the coarse triangular solves."""
    s = sh.itemsize
    for lv in sh.levels:
        smoother_step(w, lv.A, k, s, 2 * sh.smoother_steps * cycles)
        apply_op(w, lv.A, k, s, extra_vectors=1, times=cycles)
        apply_op(w, lv.P, k, s, times=cycles, transpose=True)
        apply_op(w, lv.P, k, s, extra_vectors=1, times=cycles)
    n = sh.coarse_n
    w.add(n * (n + 1) / 2 * s + 2 * n * k * s, 2.0 * n * n * k, cycles)


def cg_solve(w: Work, sh: Shapes, iterations: int, k: int = 1) -> None:
    """One preconditioned CG solve of ``iterations`` iterations on a
    ``k``-column panel: the initial residual and every iteration apply
    the Krylov operator once and the V-cycle once."""
    applies = iterations + 1
    apply_op(w, sh.krylov, k, sh.krylov_itemsize, times=applies)
    vcycles(w, sh, k, applies)


def coefficient_update(w: Work, sh: Shapes) -> None:
    """The COO scatter-sum of the assembled value stream into the fine
    operator, then each level's Galerkin product ``P^T A P``."""
    fine = sh.levels[0].A
    w.add(sh.coo_input * (9 * 8 + INDEX_BYTES) + fine.nvalid * 9 * 8,
          9.0 * sh.coo_input)
    s = sh.itemsize
    for lv in sh.levels:
        nbytes = (_matrix_bytes(lv.A, s) + _matrix_bytes(lv.P, s)
                  + lv.ac_blocks * lv.P.bc * lv.P.bc * s)
        w.add(nbytes, 2.0 * lv.ap_pairs * lv.A.br * lv.A.bc * lv.P.bc)
