"""Process meshes and balanced contiguous block-row partitions (the port's
own copy of ``repro.dist.partition``; numpy only).

Every distributed object in ``repro_torch.dist`` is laid out in row slabs:
rank r owns block rows ``[starts[r], starts[r+1])``.  Slabs differ by at
most one row, and ownership lookup is a ``searchsorted`` — the same layout
PETSc uses for Mat/Vec, which is what makes halo exchange a *neighbor*
pattern on mesh-ordered problems (``RowPartition`` / ``partition_rows``).

``ProcessMesh`` structures the device set itself.  A 1-D ``(ndev,)`` mesh
is the legacy row-slab layout: every rank owns one slab and runs the whole
apply on it.  A 2-D ``(pr, pc)`` mesh partitions **block rows × halo
neighbors**: the first axis splits the rows into ``pr`` slabs (the same
``RowPartition`` contract), the second subdivides each slab's *halo-facing
work* — the ``pc`` ranks of one row group share the slab and split its
boundary-row traffic, which divides the per-rank halo bytes by ``pc``
(``repro_torch.obs.model.dist_cycle_comm`` charges it that way).  The rank
processes of ``repro_torch.dist.solver`` consume the row axis; the column
axis is the scaling lever for the paper's 27–64 GPU points where a pure
1-D slab of a 3-D stencil has no interior left.

Validation here raises ``ValueError`` (never ``assert`` — the checks must
survive ``python -O``), mirroring the ``block_coo`` hardening.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous row slabs over ``ndev`` ranks."""

    starts: np.ndarray        # (ndev + 1,) int64, starts[0] == 0

    @property
    def ndev(self) -> int:
        return len(self.starts) - 1

    @property
    def nrows(self) -> int:
        return int(self.starts[-1])

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.starts)

    @property
    def max_count(self) -> int:
        return int(self.counts.max()) if self.ndev else 0

    def owner_of(self, rows) -> np.ndarray:
        """Owning rank of each (global) row index."""
        rows = np.asarray(rows)
        return (np.searchsorted(self.starts, rows, side="right") - 1
                ).astype(np.int64)

    def local_of(self, rows) -> np.ndarray:
        """Slab-local offset of each (global) row index."""
        rows = np.asarray(rows, dtype=np.int64)
        return rows - self.starts[self.owner_of(rows)]

    def slab(self, rank: int) -> slice:
        return slice(int(self.starts[rank]), int(self.starts[rank + 1]))


def partition_rows(nrows: int, ndev: int) -> RowPartition:
    """Balanced contiguous partition: first ``nrows % ndev`` slabs get the
    extra row (max - min <= 1).

    Raises ``ValueError`` (not assert — must survive ``python -O``) on a
    non-positive rank count or a negative row count.
    """
    nrows, ndev = int(nrows), int(ndev)
    if ndev < 1:
        raise ValueError(f"partition needs at least one rank, got "
                         f"ndev={ndev}")
    if nrows < 0:
        raise ValueError(f"cannot partition a negative row count "
                         f"(nrows={nrows})")
    base, rem = divmod(nrows, ndev)
    counts = np.full(ndev, base, dtype=np.int64)
    counts[:rem] += 1
    starts = np.zeros(ndev + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return RowPartition(starts=starts)


def partition_padded(nrows_padded: int, ndev: int) -> RowPartition:
    """Equal slabs of an already-padded row count (stacked ``(ndev, rpad)``
    slabs flattened to ``ndev * rpad`` rows).

    The padded count must divide evenly — a remainder means the stacked
    slabs and the claimed rank count disagree, which would silently
    misattribute rows to ranks; raise instead.
    """
    nrows_padded, ndev = int(nrows_padded), int(ndev)
    if ndev < 1:
        raise ValueError(f"partition needs at least one rank, got "
                         f"ndev={ndev}")
    if nrows_padded < 0:
        raise ValueError(f"cannot partition a negative row count "
                         f"(nrows_padded={nrows_padded})")
    if nrows_padded % ndev != 0:
        raise ValueError(
            f"padded row count {nrows_padded} does not divide over "
            f"{ndev} ranks (remainder {nrows_padded % ndev}): stacked "
            f"slabs must be uniform")
    return partition_rows(nrows_padded, ndev)


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The device set as a (row, halo) mesh.

    ``shape == (ndev,)`` is the legacy 1-D slab layout (``pc == 1``);
    ``shape == (pr, pc)`` keeps ``pr`` row slabs and splits each slab's
    halo-facing work ``pc`` ways (module docstring).  Construction
    validates eagerly with ``ValueError`` so a bogus mesh never reaches
    the staging loops.
    """

    shape: Tuple[int, ...]

    def __post_init__(self):
        try:
            shape = tuple(int(s) for s in self.shape)
        except TypeError:
            raise ValueError(
                f"mesh shape must be a tuple of ints, got {self.shape!r}")
        if len(shape) not in (1, 2):
            raise ValueError(
                f"mesh shape must be (ndev,) or (pr, pc), got {shape!r}")
        if any(s < 1 for s in shape):
            raise ValueError(
                f"mesh axes must be positive (ndev < 1 is meaningless), "
                f"got {shape!r}")
        object.__setattr__(self, "shape", shape)

    @property
    def pr(self) -> int:
        """Row-slab ranks (the axis the rank processes run)."""
        return self.shape[0]

    @property
    def pc(self) -> int:
        """Halo-neighbor ranks per row group (1 on a 1-D mesh)."""
        return self.shape[1] if len(self.shape) == 2 else 1

    @property
    def ndev(self) -> int:
        return self.pr * self.pc

    def row_partition(self, nbr: int) -> RowPartition:
        """Slab partition of ``nbr`` block rows over the row axis.

        A mesh with more row ranks than block rows would stage empty
        slabs whose halo plans are degenerate; refuse it loudly.
        """
        nbr = int(nbr)
        if nbr > 0 and self.pr > nbr:
            raise ValueError(
                f"mesh row axis ({self.pr} ranks) larger than the "
                f"block-row count ({nbr}): every rank needs at least one "
                f"row slab")
        return partition_rows(nbr, self.pr)


def as_mesh(mesh_or_ndev) -> ProcessMesh:
    """Coerce the dist front doors' ``ndev``-or-mesh argument.

    An ``int`` is the legacy 1-D call convention (``build_dist_gamg(setupd,
    4)``); a ``ProcessMesh`` passes through.  Anything else is a loud
    error.
    """
    if isinstance(mesh_or_ndev, ProcessMesh):
        return mesh_or_ndev
    if isinstance(mesh_or_ndev, (int, np.integer)):
        return ProcessMesh((int(mesh_or_ndev),))
    raise ValueError(
        f"expected an int rank count or a ProcessMesh, got "
        f"{mesh_or_ndev!r}")
