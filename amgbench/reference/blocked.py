"""Block-sparse matrices as plain coordinate lists of dense blocks.

``Blocked(rows, cols, vals, nbr, nbc)``: block ``vals[i]`` (``br x bc``)
sits at block row ``rows[i]``, block column ``cols[i]``; coordinates are
unique and sorted by row, then column.  Every operation is a handful of
PyTorch gathers, batched small matmuls and ``index_add_``: no kernel, plan
or cache of the program under test.
"""
from __future__ import annotations

import dataclasses

import torch

#: block pairs multiplied at once in ``matmul`` (bounds its temporaries)
PAIR_CHUNK = 4_000_000


@dataclasses.dataclass
class Blocked:
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nbr: int
    nbc: int

    def __post_init__(self):
        self.rows = self.rows.to(torch.int64)
        self.cols = self.cols.to(torch.int64)

    @property
    def br(self) -> int:
        return int(self.vals.shape[1])

    @property
    def bc(self) -> int:
        return int(self.vals.shape[2])

    @property
    def device(self):
        return self.vals.device

    @staticmethod
    def summed(rows, cols, vals, nbr: int, nbc: int) -> "Blocked":
        """Coordinates with repeats: blocks at one coordinate are summed."""
        key = rows.to(torch.int64) * nbc + cols.to(torch.int64)
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        out = torch.zeros((len(uniq),) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        out.index_add_(0, inv, vals)
        return Blocked(uniq // nbc, uniq % nbc, out, nbr, nbc)

    def indptr(self) -> torch.Tensor:
        counts = torch.bincount(self.rows, minlength=self.nbr)
        return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for ``x`` of shape ``(nbc*bc,)`` or ``(nbc*bc, k)``."""
        tail = tuple(x.shape[1:])
        xb = x.reshape((self.nbc, self.bc, -1))
        y = torch.zeros((self.nbr, self.br, xb.shape[2]), dtype=x.dtype,
                        device=x.device)
        y.index_add_(0, self.rows,
                     torch.matmul(self.vals.to(x.dtype), xb[self.cols]))
        return y.reshape((self.nbr * self.br,) + tail)

    def transpose(self) -> "Blocked":
        key = self.cols * self.nbr + self.rows
        order = torch.argsort(key)
        return Blocked(self.cols[order], self.rows[order],
                       self.vals[order].transpose(1, 2).contiguous(),
                       self.nbc, self.nbr)

    def matmul(self, other: "Blocked") -> "Blocked":
        """``A @ B``: every pair of a block ``(i, j)`` of A with a block
        ``(j, l)`` of B, multiplied and summed at ``(i, l)``."""
        if self.nbc != other.nbr or self.bc != other.br:
            raise ValueError("shapes do not chain")
        ptr = other.indptr()
        per = ptr[self.cols + 1] - ptr[self.cols]     # pairs per A block
        ends = torch.cumsum(per, 0)
        parts = []
        start = 0
        while start < len(per):
            base = int(ends[start - 1]) if start else 0
            stop = int(torch.searchsorted(ends, base + PAIR_CHUNK,
                                          right=True))
            stop = max(stop, start + 1)
            a = torch.repeat_interleave(
                torch.arange(start, stop, device=self.device),
                per[start:stop])
            first = torch.cumsum(per[start:stop], 0) - per[start:stop]
            within = torch.arange(len(a), device=self.device) \
                - torch.repeat_interleave(first, per[start:stop])
            b = ptr[self.cols[a]] + within
            parts.append(Blocked.summed(
                self.rows[a], other.cols[b],
                torch.matmul(self.vals[a], other.vals[b]),
                self.nbr, other.nbc))
            start = stop
        if not parts:
            return Blocked(self.rows[:0], self.cols[:0],
                           self.vals.new_zeros((0, self.br, other.bc)),
                           self.nbr, other.nbc)
        return Blocked.summed(torch.cat([p.rows for p in parts]),
                              torch.cat([p.cols for p in parts]),
                              torch.cat([p.vals for p in parts]),
                              self.nbr, other.nbc)

    def plus(self, other: "Blocked", alpha) -> "Blocked":
        """``self + alpha * other`` over the union of their coordinates."""
        return Blocked.summed(torch.cat([self.rows, other.rows]),
                              torch.cat([self.cols, other.cols]),
                              torch.cat([self.vals, alpha * other.vals]),
                              self.nbr, self.nbc)

    def diagonal(self) -> torch.Tensor:
        """(nbr, br, bc) diagonal blocks, zero where none is stored."""
        out = self.vals.new_zeros((self.nbr, self.br, self.bc))
        on = self.rows == self.cols
        out[self.rows[on]] = self.vals[on]
        return out

    def scale_rows(self, d: torch.Tensor) -> "Blocked":
        """``D @ A`` for block-diagonal ``D`` given as ``(nbr, br, br)``."""
        return Blocked(self.rows, self.cols,
                       torch.matmul(d[self.rows], self.vals), self.nbr,
                       self.nbc)

    def dense(self) -> torch.Tensor:
        out = self.vals.new_zeros((self.nbr, self.br, self.nbc, self.bc))
        out[self.rows, :, self.cols, :] = self.vals
        return out.reshape(self.nbr * self.br, self.nbc * self.bc)


def galerkin(P: Blocked, A: Blocked) -> Blocked:
    """``P^T A P``."""
    return P.transpose().matmul(A.matmul(P))


def relative_gap(got: Blocked, ref: Blocked) -> float:
    """Largest entry of ``|got - ref|`` over the union of both patterns,
    over the largest entry of ``|ref|`` (a block absent on one side counts
    as zero there)."""
    if (got.nbr, got.nbc, got.br, got.bc) != (ref.nbr, ref.nbc, ref.br,
                                              ref.bc):
        return float("inf")
    diff = Blocked.summed(torch.cat([got.rows, ref.rows]),
                          torch.cat([got.cols, ref.cols]),
                          torch.cat([got.vals.to(ref.vals.dtype),
                                     -ref.vals]),
                          ref.nbr, ref.nbc)
    scale = float(ref.vals.abs().max()) if len(ref.vals) else 0.0
    return float(diff.vals.abs().max()) / scale if scale else float("inf")
