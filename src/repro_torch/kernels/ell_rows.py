"""The lanes map of the blocked ELL kernels (``block_spmv``,
``block_spmm``, ``fused_smoother``).

All three kernels give each block row a sub-warp of ``lanes`` lanes
(``csrc/ell_row.cuh``): lane ``l`` walks the slots ``l, l + lanes, ...``
and the partial sums meet in a fixed butterfly, so ``lanes`` fixes the
order in which a row's products are summed.  It is therefore a function
of the operator's shape alone — the block shape and the ELL width
``kmax`` — and never a tuning knob: the autotuner's ``threads`` (threads
per CUDA block) sets how many rows share a block (``threads // lanes``)
and leaves every result bitwise the same.  All three wrappers call
``lanes``, so a panel column runs the vector's order and the smoother's
``A x`` is ``block_spmv``'s.
"""
from __future__ import annotations

#: a sub-warp divides the warp
MAX_LANES = 32
#: payload doubles a lane sums in sequence on one row, at most (short of a
#: warp per row)
DOUBLES_PER_LANE = 64


def lanes(br: int, bc: int, kmax: int) -> int:
    """Lanes per block row: the smallest power of two that leaves each
    lane at most ``DOUBLES_PER_LANE`` of the row's ``kmax * br * bc``
    payload doubles, capped at a warp.  The m=32 rows: A0 (27 slots of
    3x3) 4 lanes, P0 (8 of 3x6) 4, A1 (45 of 6x6) 32, A2 (490 of 6x6) 32,
    P2 (19 of 6x6) 16."""
    if br < 1 or bc < 1 or kmax < 0:
        raise ValueError(f"no lanes for blocks {(br, bc)}, kmax={kmax}")
    n = 1
    while n < MAX_LANES and n * DOUBLES_PER_LANE < kmax * br * bc:
        n *= 2
    return n


def check_payload(name: str, data) -> None:
    """The kernels read even-width blocks in pairs of elements (16 bytes
    at f64, 8 at f32, 4 at bf16): such payloads must start aligned to the
    pair (every allocation does; an offset view may not).  The C entry
    points refuse them as well."""
    pair = 2 * data.element_size()
    if data.shape[-1] % 2 == 0 and data.data_ptr() % pair:
        raise ValueError(f"{name}: data of {tuple(data.shape[-2:])} blocks "
                         f"must be {pair}-byte aligned (make a copy)")
