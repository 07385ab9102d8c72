"""The comparisons that decide ``correct``.

The program's outputs are read here only to be judged: a level operator
or prolongator as its padded blocked rows (``indices``, ``data``, ``mask``
tensors), its inverted diagonal blocks, its ``lam_max``, the coarse
Cholesky factor and the solutions.  Every number is a relative gap to the
reference, taken at the worst level, step or request; ``CHECKS`` names
them in the order a result line prints them.
"""
from __future__ import annotations

import torch

from amgbench.reference import fem
from amgbench.reference import hierarchy as ref_h
from amgbench.reference.blocked import Blocked, relative_gap

CHECKS = ("fine_operator", "coarse_operators", "prolongators", "smoother",
          "coarse_factor", "residual")


def from_padded(indices, data, mask, nbc: int) -> Blocked:
    """A padded blocked layout's stored blocks, at f64."""
    nbr, kmax = indices.shape
    rows = torch.arange(nbr, device=data.device)[:, None].expand(nbr, kmax)
    keep = mask.to(torch.bool)
    return Blocked(rows[keep], indices.to(torch.int64)[keep],
                   data[keep].to(torch.float64), nbr, nbc)


def _ell(e) -> Blocked:
    return from_padded(e.indices, e.data, e.mask, e.nbc)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.to(torch.float64)
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale


class Judge:
    """The reference side of one configuration: set-up operator,
    near-null space and the program's aggregates in, reference
    prolongators out; then hierarchies and solutions judged against it.

    ``worst`` keeps the largest gap of each check over everything
    judged; a non-finite gap stays non-finite."""

    def __init__(self, m: int, E0: float, nu0: float, aggregates: list,
                 device):
        self.m, self.device = m, device
        ne = (m - 1) ** 3
        self.uniform = (torch.full((ne,), E0, dtype=torch.float64,
                                   device=device),
                        torch.full((ne,), nu0, dtype=torch.float64,
                                   device=device))
        A0 = fem.assemble(m, *self.uniform)
        B0 = torch.as_tensor(fem.rigid_body_modes(m), device=device)
        self.Ps = ref_h.prolongators(A0, B0, aggregates)
        self.worst = {name: 0.0 for name in CHECKS}

    def _note(self, name: str, gap: float) -> None:
        if not gap <= self.worst[name]:       # NaN sticks
            self.worst[name] = gap

    def operator(self, E=None, nu=None) -> Blocked:
        if E is None:
            E, nu = self.uniform
        return fem.assemble(self.m, E, nu)

    def hierarchy(self, hier, E=None, nu=None) -> Blocked:
        """Judge the program's hierarchy of fields ``E``, ``nu`` (the
        set-up material when None); returns the reference fine operator."""
        A0 = self.operator(E, nu)
        lvls, coarse = ref_h.levels(A0, self.Ps)
        if len(hier.levels) != len(lvls):
            for name in ("coarse_operators", "smoother", "coarse_factor"):
                self._note(name, float("inf"))
            return A0
        fine = [relative_gap(_ell(hier.levels[0].a_ell), A0)]
        if getattr(hier, "a_fine_ell", None) is not None:
            fine.append(relative_gap(_ell(hier.a_fine_ell), A0))
        self._note("fine_operator", max(fine))
        for li, (lv, ref) in enumerate(zip(hier.levels, lvls)):
            if li:
                self._note("coarse_operators",
                           relative_gap(_ell(lv.a_ell), ref.A))
            self._note("prolongators",
                       relative_gap(_ell(lv.p_ell), self.Ps[li]))
            self._note("smoother", max(
                _rel(lv.dinv, ref.dinv),
                abs(float(lv.lam_max) - ref.lam_max) / ref.lam_max))
        L = hier.coarse_chol.to(torch.float64)
        self._note("coarse_factor", _rel(L @ L.T, coarse))
        return A0

    def solution(self, A: Blocked, b: torch.Tensor, x) -> None:
        """Judge one solution by its true residual under the reference
        operator ``A``."""
        x = torch.as_tensor(x, device=self.device, dtype=torch.float64)
        b = b.to(torch.float64)
        r = torch.linalg.vector_norm(b - A.matvec(x)) \
            / torch.linalg.vector_norm(b)
        self._note("residual", float(r))
