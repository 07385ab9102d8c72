"""Smoothed-aggregation hierarchy, worked out plainly from the aggregates.

Given a level operator, its near-null space and the aggregates, the
tentative prolongator is the QR factor of each aggregate's near-null rows
(the sign fixed so that R has a positive diagonal, which makes Q unique);
the smoothed prolongator is ``P = (I - omega D^-1 A) T`` with ``omega =
(4/3) / lambda_max(D^-1 A)``; the next operator is ``P^T A P``.  Each level
carries the inverted diagonal blocks and ``lambda_max(D^-1 A)`` that its
Chebyshev smoother reads.  ``lambda_max`` is ten steps of the power
iteration from the normalised ones vector, the estimate the smoother is
defined with.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amgbench.reference.blocked import Blocked, galerkin

POWER_STEPS = 10
OMEGA_SCALE = 4.0 / 3.0


@dataclasses.dataclass
class Level:
    A: Blocked
    dinv: torch.Tensor
    lam_max: float


def lambda_max(A: Blocked, dinv: torch.Tensor) -> float:
    DA = A.scale_rows(dinv)
    x = torch.ones(A.nbr * A.br, dtype=A.vals.dtype, device=A.device)
    x = x / torch.linalg.vector_norm(x)
    tiny = torch.finfo(x.dtype).tiny
    for _ in range(POWER_STEPS):
        y = DA.matvec(x)
        x = y / torch.clamp_min(torch.linalg.vector_norm(y), tiny)
    return float(torch.linalg.vector_norm(DA.matvec(x)))


def level(A: Blocked) -> Level:
    dinv = torch.linalg.inv(A.diagonal())
    return Level(A, dinv, lambda_max(A, dinv))


def tentative(node_to_agg: np.ndarray, B: torch.Tensor, bs: int
              ) -> tuple[Blocked, torch.Tensor]:
    """``(T, B_c)``: T has one ``bs x nns`` block a node, at its aggregate;
    ``B_c`` stacks each aggregate's R."""
    n, nns = len(node_to_agg), B.shape[1]
    dev = B.device
    agg = torch.as_tensor(node_to_agg, device=dev)
    n_agg = int(node_to_agg.max()) + 1
    Bn = B.reshape(n, bs, nns)
    t_vals = torch.empty((n, bs, nns), dtype=B.dtype, device=dev)
    bc = torch.empty((n_agg, nns, nns), dtype=B.dtype, device=dev)
    order = np.argsort(node_to_agg, kind="stable")
    sizes = np.bincount(node_to_agg, minlength=n_agg)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for size in np.unique(sizes):
        aggs = np.flatnonzero(sizes == size)
        members = order[starts[aggs][:, None] + np.arange(size)]  # (g, size)
        idx = torch.as_tensor(members, device=dev)
        Q, R = torch.linalg.qr(Bn[idx].reshape(len(aggs), size * bs, nns))
        s = torch.sign(torch.diagonal(R, dim1=1, dim2=2))
        s = torch.where(s == 0, torch.ones_like(s), s)
        t_vals[idx.reshape(-1)] = (Q * s[:, None, :]).reshape(-1, bs, nns)
        bc[torch.as_tensor(aggs, device=dev)] = R * s[:, :, None]
    T = Blocked(torch.arange(n, device=dev), agg, t_vals, n, n_agg)
    return T, bc.reshape(n_agg * nns, nns)


def prolongators(A0: Blocked, B0: torch.Tensor, aggregates: list
                 ) -> list[Blocked]:
    """The smoothed prolongator of every level, built on the set-up
    operator ``A0`` with near-null space ``B0`` and the given aggregates
    (``node_to_agg`` of each level, finest first)."""
    A, B, out = A0, B0, []
    for node_to_agg in aggregates:
        lv = level(A)
        T, B = tentative(node_to_agg, B, A.br)
        DAT = A.scale_rows(lv.dinv).matmul(T)
        P = T.plus(DAT, -OMEGA_SCALE / lv.lam_max)
        out.append(P)
        A = galerkin(P, A)
    return out


def levels(A0: Blocked, Ps: list) -> tuple[list[Level], torch.Tensor]:
    """The smoother data of every level above the coarsest, and the
    coarsest operator, dense."""
    A, out = A0, []
    for P in Ps:
        out.append(level(A))
        A = galerkin(P, A)
    return out, A.dense()
