"""Rectangular-block sparse containers (torch twin of ``repro.core.block_csr``).

Host-symbolic / device-numeric split, as in the reference:

* ``indptr`` / ``indices`` (the structure) are host numpy arrays, and every
  symbolic phase consumes them: on the host, or, for the SpGEMM and AXPY
  plans (``core.spgemm``), copied to the operators' device and back;
* ``data`` (the values) is a torch tensor of dense ``(nnzb, br, bc)`` blocks
  on the chosen device.

Plans are numpy.  The index arrays a numeric phase needs on the device are
copied there once per device (``device_array``) and reused by every hot
recompute.  A structure-only operand (for symbolic products) carries a
``meta``-device data tensor: shape without storage.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

#: a monotone counter mirroring PetscObjectState: every new structure
#: (``BlockCSR.from_arrays``) takes the next token, a numeric update
#: (``with_data``) keeps its own
_STATE_TOKENS = itertools.count(1)


def device_array(plan, name: str, device, dtype=torch.int64) -> torch.Tensor:
    """``plan.<name>`` (a numpy array) as a tensor on ``device``, cached on
    the plan so hot numeric phases copy each index array to the device once.
    """
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = (name, str(torch.device(device)), dtype)
    t = cache.get(key)
    if t is None:
        t = torch.tensor(np.asarray(getattr(plan, name)), dtype=dtype,
                         device=device)
        cache[key] = t
    return t


@dataclasses.dataclass
class BlockCSR:
    """Rectangular-block CSR: ``nbr x nbc`` grid of ``br x bc`` dense blocks."""

    indptr: np.ndarray      # (nbr+1,) int64, host
    indices: np.ndarray     # (nnzb,) int32, host
    data: torch.Tensor      # (nnzb, br, bc), device
    nbc: int
    state_token: int = 0    # a new one whenever a structure is created

    @property
    def nbr(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnzb(self) -> int:
        return int(self.indices.shape[0])

    @property
    def br(self) -> int:
        return int(self.data.shape[1])

    @property
    def bc(self) -> int:
        return int(self.data.shape[2])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nbr * self.br, self.nbc * self.bc)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_arrays(indptr, indices, data: torch.Tensor, nbc) -> "BlockCSR":
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int32)
        if not isinstance(data, torch.Tensor) or data.ndim != 3:
            raise ValueError("data must be a (nnzb, br, bc) torch tensor")
        if data.shape[0] != indices.shape[0]:
            raise ValueError(f"{data.shape[0]} data blocks for "
                             f"{indices.shape[0]} indices")
        return BlockCSR(indptr, indices, data, int(nbc),
                        state_token=next(_STATE_TOKENS))

    def with_data(self, data: torch.Tensor) -> "BlockCSR":
        """Same structure, new values (numeric update; keeps the state
        token)."""
        if data.shape != self.data.shape:
            raise ValueError(f"{tuple(data.shape)} != "
                             f"{tuple(self.data.shape)}")
        return BlockCSR(self.indptr, self.indices, data, self.nbc,
                        self.state_token)

    def row_of_nnz(self) -> np.ndarray:
        return np.repeat(np.arange(self.nbr), np.diff(self.indptr))

    def to_dense(self) -> torch.Tensor:
        """Densify (tests / coarse solve only — never on the hot path).
        Blocks of a CSR are unique, so a plain index assignment places them.
        """
        br, bc = self.br, self.bc
        out = torch.zeros((self.nbr, self.nbc, br, bc), dtype=self.data.dtype,
                          device=self.device)
        rows = torch.as_tensor(self.row_of_nnz(), device=self.device)
        cols = torch.as_tensor(self.indices.astype(np.int64),
                               device=self.device)
        out[rows, cols] = self.data
        return out.permute(0, 2, 1, 3).reshape(self.shape)

    def ell_plan(self) -> "ELLPlan":
        """Host symbolic phase of the BCSR -> BlockELL conversion."""
        counts = np.diff(self.indptr)
        kmax = int(counts.max()) if len(counts) else 0
        nbr = self.nbr
        idx = np.zeros((nbr, kmax), dtype=np.int32)
        sel = np.full((nbr, kmax), -1, dtype=np.int64)
        for_r = np.repeat(np.arange(nbr), counts)
        within = np.arange(self.nnzb) - np.repeat(self.indptr[:-1], counts)
        idx[for_r, within] = self.indices
        sel[for_r, within] = np.arange(self.nnzb)
        mask = sel >= 0
        gather = np.where(mask, sel, 0)
        return ELLPlan(indices=idx, gather=gather, mask=mask,
                       lengths=counts.astype(np.int32), nbc=self.nbc)

    def to_ell(self) -> "BlockELL":
        return self.ell_plan().build(self.data)

    def block_norms(self) -> torch.Tensor:
        """Frobenius norm of every block (strength-of-connection input)."""
        return torch.sqrt(torch.sum(self.data * self.data, dim=(1, 2)))

    def diagonal_blocks(self) -> torch.Tensor:
        """(nbr, br, bc) diagonal blocks (zero where absent)."""
        if self.br != self.bc:
            raise ValueError("diagonal blocks need square blocks")
        rows = self.row_of_nnz()
        is_diag = rows == self.indices
        out = torch.zeros((self.nbr, self.br, self.bc), dtype=self.data.dtype,
                          device=self.device)
        dst = torch.as_tensor(rows[is_diag], device=self.device)
        src = torch.as_tensor(np.flatnonzero(is_diag), device=self.device)
        out[dst] = self.data[src]
        return out


@dataclasses.dataclass(frozen=True)
class ELLPlan:
    """Cached structure of a BCSR -> ELL conversion (host symbolic)."""

    indices: np.ndarray   # (nbr, kmax) int32, padded -> block col 0
    gather: np.ndarray    # (nbr, kmax) int64 into BCSR data
    mask: np.ndarray      # (nbr, kmax) bool
    lengths: np.ndarray   # (nbr,) int32 valid slots a row, first in it
    nbc: int

    def ell_data(self, data: torch.Tensor) -> torch.Tensor:
        """Numeric phase: BCSR values into the ELL layout (device gather);
        padded slots become exact zero blocks."""
        dev = data.device
        g = data[device_array(self, "gather", dev)]
        m = device_array(self, "mask", dev, torch.bool)[..., None, None]
        return torch.where(m, g, torch.zeros((), dtype=data.dtype,
                                             device=dev))

    def build(self, data: torch.Tensor) -> "BlockELL":
        dev = data.device
        return BlockELL(indices=device_array(self, "indices", dev,
                                             torch.int32),
                        data=self.ell_data(data),
                        mask=device_array(self, "mask", dev, torch.bool),
                        nbc=self.nbc,
                        lengths=device_array(self, "lengths", dev,
                                             torch.int32))


@dataclasses.dataclass
class BlockELL:
    """Padded fixed-width blocked layout (the SpMV kernels' operand)."""

    indices: torch.Tensor   # (nbr, kmax) int32, padded slots -> column 0
    data: torch.Tensor      # (nbr, kmax, br, bc); padded blocks exactly zero
    mask: torch.Tensor      # (nbr, kmax) bool
    nbc: int
    #: (nbr,) int32 valid slots a row (they come first), on the data's
    #: device; None: unknown, a kernel then walks every row to kmax
    lengths: Optional[torch.Tensor] = None

    @property
    def nbr(self) -> int:
        return int(self.indices.shape[0])

    @property
    def kmax(self) -> int:
        return int(self.indices.shape[1])

    @property
    def br(self) -> int:
        return int(self.data.shape[2])

    @property
    def bc(self) -> int:
        return int(self.data.shape[3])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nbr * self.br, self.nbc * self.bc)


# ---------------------------------------------------------------------------
# Structure helpers (host, numpy — bitwise the reference's)
# ---------------------------------------------------------------------------

def coo_to_csr_structure(rows: np.ndarray, cols: np.ndarray, nbr: int,
                         sum_duplicates: bool = True):
    """Sort/unique (row, col) COO coordinates into CSR structure.

    Returns ``(indptr, indices, order, out_idx, nnzb)``: ``order`` stably
    sorts the input coordinates and ``out_idx[i]`` is the output slot of
    input coordinate ``i`` (after dedup).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    ncols = int(cols.max()) + 1 if len(cols) else 0
    key = rows * max(ncols, 1) + cols
    order = np.argsort(key, kind="stable")
    skey = key[order]
    if sum_duplicates:
        uniq, inv_sorted = np.unique(skey, return_inverse=True)
    else:
        uniq, inv_sorted = skey, np.arange(len(skey))
    nnzb = len(uniq)
    out_idx = np.empty(len(key), dtype=np.int64)
    out_idx[order] = inv_sorted
    u_rows = uniq // max(ncols, 1)
    u_cols = uniq % max(ncols, 1)
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, u_cols.astype(np.int32), order, out_idx, nnzb


def transpose_structure(indptr: np.ndarray, indices: np.ndarray, nbc: int):
    """Symbolic CSR transpose: returns ``(t_indptr, t_indices, perm)`` with
    ``perm[k]`` the input position of output nonzero ``k``."""
    nbr = len(indptr) - 1
    rows = np.repeat(np.arange(nbr), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    key = cols * nbr + rows
    perm = np.argsort(key, kind="stable")
    t_rows = cols[perm]
    t_cols = rows[perm]
    t_indptr = np.zeros(nbc + 1, dtype=np.int64)
    np.add.at(t_indptr, t_rows + 1, 1)
    t_indptr = np.cumsum(t_indptr)
    return t_indptr, t_cols.astype(np.int32), perm


def transpose_bcsr(A: BlockCSR) -> BlockCSR:
    """Full (symbolic + numeric) blocked transpose."""
    t_indptr, t_indices, perm = transpose_structure(A.indptr, A.indices,
                                                    A.nbc)
    t_data = A.data[torch.as_tensor(perm, device=A.device)].transpose(1, 2)
    return BlockCSR.from_arrays(t_indptr, t_indices, t_data.contiguous(),
                                A.nbr)


@dataclasses.dataclass(frozen=True)
class EllTransposePlan:
    """Build-time plan for applying ``A^T`` straight off A's ELL blocks
    (the transpose-free restriction, ``repro_torch.core.spmv.apply_ell_t``).
    Slot order per output row matches ``transpose_structure``'s."""

    rows: np.ndarray     # (nbc, tkmax) int32 — A's block row per slot
    gather: np.ndarray   # (nbc, tkmax) int32 — flattened (nbr*kmax) slots
    mask: np.ndarray     # (nbc, tkmax) bool — False on padded slots
    nbr: int             # block rows of the underlying A


def transpose_apply_plan(A: BlockCSR, kmax: int) -> EllTransposePlan:
    """Host symbolic phase of the transpose-free ``A^T`` apply; ``kmax`` is
    the slot width of A's ELL form."""
    counts = np.diff(A.indptr)
    for_r = np.repeat(np.arange(A.nbr), counts)
    within = np.arange(A.nnzb) - np.repeat(A.indptr[:-1], counts)
    slot = for_r * kmax + within
    t_indptr, t_rows, perm = transpose_structure(A.indptr, A.indices, A.nbc)
    t_counts = np.diff(t_indptr)
    tkmax = max(int(t_counts.max()) if len(t_counts) else 0, 1)
    rows = np.zeros((A.nbc, tkmax), dtype=np.int32)
    gather = np.zeros((A.nbc, tkmax), dtype=np.int32)
    mask = np.zeros((A.nbc, tkmax), dtype=bool)
    out_r = np.repeat(np.arange(A.nbc), t_counts)
    out_w = np.arange(A.nnzb) - np.repeat(t_indptr[:-1], t_counts)
    rows[out_r, out_w] = t_rows
    gather[out_r, out_w] = slot[perm]
    mask[out_r, out_w] = True
    return EllTransposePlan(rows=rows, gather=gather, mask=mask, nbr=A.nbr)


def identity_bcsr(nbr: int, bs: int, dtype=torch.float64, *,
                  device="cuda") -> BlockCSR:
    """The ``nbr x nbr`` block identity of ``bs x bs`` blocks on
    ``device``."""
    from repro_torch.kernels.backend import resolve_device
    dev = resolve_device(device)
    eye = torch.eye(bs, dtype=dtype, device=dev).expand(nbr, bs, bs)
    return BlockCSR.from_arrays(np.arange(nbr + 1, dtype=np.int64),
                                np.arange(nbr, dtype=np.int32),
                                eye.contiguous(), nbr)
