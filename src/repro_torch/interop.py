"""Carry state across from numpy: the port's objects from plain arrays.

Lets a caller run the port's hot path (``recompute``, ``vcycle``, ``pcg``)
on exactly another implementation's operators, prolongators and
hierarchies — handed over as numpy arrays — so hot-path parity can be
checked apart from cold-setup parity; likewise an LM's param tree, its
decode cache and a training state (params and optimizer moments).
Structures are taken as given; every plan is rebuilt by the port's own
symbolic phases (host numpy).
Payloads keep their own dtype (f64, f32, or bf16 as ``ml_dtypes``'
``bfloat16``, carried bitwise through its 16-bit pattern), so a
reduced-precision hierarchy crosses as it is.  Imports nothing but numpy,
torch and this package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import Aggregation
from repro_torch.core.block_coo import set_values_coo
from repro_torch.core.block_csr import BlockCSR, BlockELL, EllTransposePlan, \
    transpose_apply_plan
from repro_torch.core.gamg import GAMGSetup, LevelSetup
from repro_torch.core.ptap import ptap_symbolic
from repro_torch.core.vcycle import Hierarchy, LevelState
from repro_torch.fem.assemble import ElasticityProblem, coo_plan
from repro_torch.fem.device_stiffness import DeviceAssembler
from repro_torch.fem.hex_elasticity import hex_mesh
from repro_torch.kernels.backend import resolve_device, resolve_precision
from repro_torch.models.transformer import tree_map


def _t(a, device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` on ``device``, at ``dtype`` or its own; a bf16 array
    crosses as its bit pattern (numpy's int16 view, then torch's bf16
    view)."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, dtype=dtype).to(device)


def bcsr_from_numpy(indptr, indices, data, nbc: int, *,
                    device="cuda") -> BlockCSR:
    """A ``BlockCSR`` from host structure and ``(nnzb, br, bc)`` values (at
    their own dtype)."""
    dev = resolve_device(device)
    return BlockCSR.from_arrays(np.asarray(indptr), np.asarray(indices),
                                _t(data, dev), nbc)


def problem_from_numpy(m: int, *, values, b, B, order: int = 1,
                       E_field=None, nu_field=None,
                       device="cuda") -> ElasticityProblem:
    """An ``ElasticityProblem`` on the ``m^3`` grid (z=0 face clamped) with
    the given value stream, load ``b`` and near-null space ``B``; mesh and
    COO plan are rebuilt on the host and ``A`` assembled from ``values``.

    With per-element ``E_field`` and ``nu_field`` (a device-path problem)
    the problem also gets its ``DeviceAssembler`` and those fields, so
    ``update_coefficients`` and ``GAMGSolver.bind_assembler`` work on it;
    ``values`` is taken as given either way."""
    dev = resolve_device(device)
    mesh = hex_mesh(m, order)
    plan, free = coo_plan(mesh)
    vals = _t(values, dev)
    assembler = E = nu = None
    if (E_field is None) != (nu_field is None):
        raise ValueError("pass both E_field and nu_field, or neither")
    if E_field is not None:
        assembler = DeviceAssembler.build(mesh, plan, dev)
        E, nu = assembler.as_fields(np.asarray(E_field),
                                    np.asarray(nu_field))
    return ElasticityProblem(A=set_values_coo(plan, vals),
                             b=_t(b, dev), B=_t(B, dev), mesh=mesh,
                             free_nodes=free, coo_plan=plan, values=vals,
                             assembler=assembler, E_field=E, nu_field=nu)


def setup_from_numpy(levels: Sequence[dict], coarse: dict, *,
                     smoother: str = "chebyshev", degree: int = 2,
                     theta: float = 0.08, nns_dim: int = 6,
                     coarsener: str = "mis", precision=None,
                     device="cuda") -> GAMGSetup:
    """A ``GAMGSetup`` from per-level arrays.

    Each entry of ``levels`` holds ``A0`` and ``P`` as dicts of
    ``indptr, indices, data, nbc``, the aggregates ``node_to_agg`` and the
    damping ``omega``; ``coarse`` is the coarsest operator as such a dict.
    A level that also holds ``R`` (such a dict: the stored restriction of
    ``setup(restriction="stored")``) keeps it and its ELL form and gets no
    transpose-apply plan.  The PtAP, ELL and transpose-apply plans are
    rebuilt from the structures by the port's symbolic phases.  ``coarsener`` names the
    coarsener that made the aggregates (``"mis"``, the default, or
    ``"greedy"``), as ``setup`` records it; ``precision`` the policy, as
    ``setup`` takes it.
    """
    if coarsener not in ("mis", "greedy"):
        raise ValueError(f"invalid coarsener {coarsener!r}: "
                         f"expected 'mis' or 'greedy'")
    dev = resolve_device(device)
    out = []
    for lv in levels:
        A0 = bcsr_from_numpy(**lv["A0"], device=dev)
        P = bcsr_from_numpy(**lv["P"], device=dev)
        agg = np.asarray(lv["node_to_agg"], dtype=np.int64)
        p_ell = P.to_ell()
        R = bcsr_from_numpy(**lv["R"], device=dev) if lv.get("R") \
            else None
        out.append(LevelSetup(
            A0=A0, P=P, ptap_cache=ptap_symbolic(A0, P),
            a_ell_plan=A0.ell_plan(), p_ell=p_ell,
            aggr=Aggregation(node_to_agg=agg, n_agg=P.nbc),
            omega=_t(lv["omega"], dev), n_fine=A0.nbr, n_coarse=P.nbc,
            pt=None if R is not None else transpose_apply_plan(P,
                                                               p_ell.kmax),
            R=R, r_ell=None if R is None else R.to_ell()))
    Ac = bcsr_from_numpy(**coarse, device=dev)
    ops = [ls.A0 for ls in out] + [Ac]
    stats = {"level_rows": [a.nbr * a.br for a in ops],
             "level_nnzb": [a.nnzb for a in ops],
             "level_bs": [a.br for a in ops], "conversions_to_scalar": 0}
    bs_fine = out[0].A0.br if out else Ac.br
    return GAMGSetup(levels=out, coarse_struct=Ac, bs_fine=bs_fine,
                     nns_dim=nns_dim, smoother=smoother, degree=degree,
                     theta=theta, coarsener=coarsener, stats=stats,
                     precision=resolve_precision(precision))


def _ell(d: dict, dev) -> BlockELL:
    return BlockELL(indices=_t(d["indices"], dev, torch.int32),
                    data=_t(d["data"], dev),
                    mask=_t(d["mask"], dev, torch.bool), nbc=int(d["nbc"]))


def hierarchy_from_numpy(levels: Sequence[dict], coarse_chol, *,
                         a_fine_ell: dict | None = None,
                         device="cuda") -> Hierarchy:
    """A ``Hierarchy`` from per-level arrays: ``a_ell`` and ``p_ell`` as
    dicts of ``indices, data, mask, nbc``, ``dinv``, ``lam_max`` and
    ``p_t`` as a dict of ``rows, gather, mask, nbr`` (transpose-free) or
    ``r_ell`` as a dict like ``a_ell`` (a stored restriction); plus the
    coarse
    lower Cholesky factor and, for a mixed-precision hierarchy, the
    krylov-dtype finest operator ``a_fine_ell`` (a dict like ``a_ell``).
    Every payload keeps its dtype."""
    dev = resolve_device(device)
    states = []
    for lv in levels:
        pt, r_ell = lv.get("p_t"), lv.get("r_ell")
        states.append(LevelState(
            a_ell=_ell(lv["a_ell"], dev), p_ell=_ell(lv["p_ell"], dev),
            dinv=_t(lv["dinv"], dev), lam_max=_t(lv["lam_max"], dev),
            p_t=None if pt is None else EllTransposePlan(
                rows=np.asarray(pt["rows"], np.int32),
                gather=np.asarray(pt["gather"], np.int32),
                mask=np.asarray(pt["mask"], bool), nbr=int(pt["nbr"])),
            r_ell=None if r_ell is None else _ell(r_ell, dev)))
    return Hierarchy(levels=tuple(states), coarse_chol=_t(coarse_chol, dev),
                     a_fine_ell=None if a_fine_ell is None
                     else _ell(a_fine_ell, dev))


def lm_params_from_numpy(tree, device="cuda", dtype=torch.float32) -> dict:
    """An LM param tree (``repro_torch.models.transformer``'s) from the
    reference's as nested dicts of numpy arrays (e.g. ``jax.tree_util.
    tree_map(np.asarray, params)``): the same keys, every leaf at
    ``dtype`` (the fp32 masters by default) on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _t(a, dev, dtype), tree)


def lm_cache_from_numpy(tree, device="cuda") -> dict:
    """A stacked decode cache from the reference's as nested dicts of numpy
    arrays: the same keys, each leaf at its own dtype (a bf16 cache
    crosses bitwise)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _t(a, dev), tree)


def train_state_from_numpy(state, device="cuda") -> dict:
    """A training state from the reference's ``{"params", "opt": {"mu",
    "nu", "step"}}`` (and any other leaves, e.g. a ``"loss"``) as nested
    dicts of numpy arrays: the same keys, every leaf at its own dtype (fp32
    params and moments, the 0-d int32 step) on ``device``, as
    ``lm_cache_from_numpy`` carries a cache."""
    return lm_cache_from_numpy(state, device)
