"""The port's own copy of the partition layer
(``repro_torch.dist.partition``) against ``repro.dist.partition``:
bitwise on the same inputs, plus the cases of
``tests/test_process_mesh.py`` on the port (pure numpy, no devices; the
validation contract is ``ValueError``, never ``assert``)."""
import numpy as np
import pytest

from repro.dist import partition as ref

from repro_torch.dist import partition as port
from repro_torch.dist.partition import (
    ProcessMesh,
    as_mesh,
    partition_padded,
    partition_rows,
)

SIZES = [(0, 1), (0, 3), (1, 1), (5, 5), (7, 3), (10, 3), (100, 4),
         (95232 // 3, 4), (882 // 3, 8), (13, 64)]


@pytest.mark.parametrize("nrows,ndev", SIZES,
                         ids=[f"{n}x{d}" for n, d in SIZES])
def test_partition_rows_matches_reference(nrows, ndev):
    want = ref.partition_rows(nrows, ndev)
    got = port.partition_rows(nrows, ndev)
    assert got.starts.dtype == want.starts.dtype
    assert got.starts.tobytes() == want.starts.tobytes()
    assert (got.ndev, got.nrows, got.max_count) == \
        (want.ndev, want.nrows, want.max_count)
    rows = np.arange(nrows)
    for fn in ("owner_of", "local_of"):
        a, b = getattr(want, fn)(rows), getattr(got, fn)(rows)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), fn
    assert [got.slab(r) for r in range(ndev)] == \
        [want.slab(r) for r in range(ndev)]


@pytest.mark.parametrize("nrows,ndev", [(8, 2), (12, 4), (0, 3)])
def test_partition_padded_matches_reference(nrows, ndev):
    assert port.partition_padded(nrows, ndev).starts.tobytes() == \
        ref.partition_padded(nrows, ndev).starts.tobytes()


@pytest.mark.parametrize("shape", [(4,), (2, 32), (3, 2), (1, 1)])
def test_process_mesh_matches_reference(shape):
    want, got = ref.ProcessMesh(shape), port.ProcessMesh(shape)
    assert (got.shape, got.pr, got.pc, got.ndev) == \
        (want.shape, want.pr, want.pc, want.ndev)
    nbr = 64
    assert got.row_partition(nbr).starts.tobytes() == \
        want.row_partition(nbr).starts.tobytes()


# -- the cases of tests/test_process_mesh.py, on the port ------------------

def test_partition_rows_balance_and_lookup():
    part = partition_rows(10, 3)
    assert part.ndev == 3 and part.nrows == 10
    assert list(part.counts) == [4, 3, 3]        # max - min <= 1
    assert part.max_count == 4
    assert list(part.owner_of([0, 3, 4, 9])) == [0, 0, 1, 2]
    assert list(part.local_of([0, 3, 4, 9])) == [0, 3, 0, 2]
    assert part.slab(1) == slice(4, 7)


def test_partition_rows_validation():
    with pytest.raises(ValueError, match="at least one rank"):
        partition_rows(10, 0)
    with pytest.raises(ValueError, match="at least one rank"):
        partition_rows(10, -2)
    with pytest.raises(ValueError, match="negative row count"):
        partition_rows(-1, 2)
    assert partition_rows(0, 2).nrows == 0       # empty is fine


def test_partition_padded_divisibility():
    assert list(partition_padded(8, 2).counts) == [4, 4]
    with pytest.raises(ValueError, match="does not divide"):
        partition_padded(9, 2)
    with pytest.raises(ValueError, match="at least one rank"):
        partition_padded(8, 0)


def test_process_mesh_shapes():
    m1 = ProcessMesh((4,))
    assert (m1.pr, m1.pc, m1.ndev) == (4, 1, 4)
    m2 = ProcessMesh((2, 32))
    assert (m2.pr, m2.pc, m2.ndev) == (2, 32, 64)
    m3 = ProcessMesh((np.int64(3), np.int64(2)))
    assert m3.shape == (3, 2)


def test_process_mesh_validation():
    with pytest.raises(ValueError, match="must be positive"):
        ProcessMesh((0,))
    with pytest.raises(ValueError, match="must be positive"):
        ProcessMesh((2, 0))
    with pytest.raises(ValueError, match=r"\(ndev,\) or \(pr, pc\)"):
        ProcessMesh((2, 2, 2))
    with pytest.raises(ValueError, match="tuple of ints"):
        ProcessMesh(3)


def test_process_mesh_row_partition():
    mesh = ProcessMesh((2, 4))
    part = mesh.row_partition(5)
    assert part.ndev == 2 and part.nrows == 5    # rows follow pr only
    with pytest.raises(ValueError, match="larger than the block-row"):
        ProcessMesh((8, 1)).row_partition(5)
    assert ProcessMesh((8, 1)).row_partition(0).nrows == 0


def test_as_mesh_coercion():
    assert as_mesh(3).shape == (3,)
    assert as_mesh(np.int32(2)).shape == (2,)
    mesh = ProcessMesh((2, 2))
    assert as_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="int rank count or a ProcessMesh"):
        as_mesh("4")
    with pytest.raises(ValueError, match="int rank count or a ProcessMesh"):
        as_mesh((2, 2))
