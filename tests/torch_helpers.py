"""Shared pieces of the ``test_torch_*`` parity tests: the two small cases,
error measures, and the JAX reference's objects turned into the numpy
dicts ``repro_torch.interop`` takes."""
from __future__ import annotations

import numpy as np

#: (m, coarse_size, reference level_rows, reference CG iterations); the
#: greedy coarsener.  m=7 / coarse_size=12 exercises a 6x6 level and the
#: (6,6,6) Galerkin products.
CASES = [(6, 100, [540, 66], 9), (7, 12, [882, 108, 60], 9)]
CASE_IDS = ["m6-cs100", "m7-cs12"]

#: float payloads: f64 agreement to 1e-12 relative (the port reorders sums)
REL = 1e-12


def to_np(x) -> np.ndarray:
    """A JAX or torch array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = to_np(got), to_np(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() if want.size else 0.0
    return float(err / scale) if scale else float(err)


def assert_close(got, want, rel: float = REL) -> None:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = rel_err(got, want)
    assert err <= rel, f"relative error {err:.3e} > {rel:.1e}"


def bcsr_dict(A) -> dict:
    return dict(indptr=np.asarray(A.indptr), indices=np.asarray(A.indices),
                data=np.asarray(A.data), nbc=A.nbc)


def setup_to_numpy(s):
    """A ``repro.core.gamg.GAMGSetup`` as ``interop.setup_from_numpy``'s
    arguments (with ``R`` where the setup stores its restriction)."""
    levels = [dict(A0=bcsr_dict(ls.A0), P=bcsr_dict(ls.P),
                   node_to_agg=np.asarray(ls.aggr.node_to_agg),
                   omega=np.asarray(ls.omega),
                   R=None if ls.R is None else bcsr_dict(ls.R))
              for ls in s.levels]
    return levels, bcsr_dict(s.coarse_struct)


def _ell_dict(e) -> dict:
    return dict(indices=np.asarray(e.indices), data=np.asarray(e.data),
                mask=np.asarray(e.mask), nbc=e.nbc)


def hierarchy_to_numpy(h):
    """A ``repro.core.vcycle.Hierarchy`` (transpose-free, or with a stored
    ``r_ell``) as ``interop.hierarchy_from_numpy``'s arguments."""
    levels = [dict(a_ell=_ell_dict(lv.a_ell), p_ell=_ell_dict(lv.p_ell),
                   dinv=np.asarray(lv.dinv), lam_max=np.asarray(lv.lam_max),
                   p_t=None if lv.p_t is None else dict(
                       rows=np.asarray(lv.p_t.rows),
                       gather=np.asarray(lv.p_t.gather),
                       mask=np.asarray(lv.p_t.mask), nbr=lv.p_t.nbr),
                   r_ell=None if lv.r_ell is None else _ell_dict(lv.r_ell))
              for lv in h.levels]
    return levels, np.asarray(h.coarse_chol)
