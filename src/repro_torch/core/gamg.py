"""GAMG — smoothed-aggregation AMG with the paper's hot/cold split (torch
twin of ``repro.core.gamg``).

``setup``      cold phase: strength graph, aggregation (the device
               Luby-MIS coarsener by default, the host greedy covering on
               request), tentative + smoothed prolongators, every
               SpGEMM/transpose/ELL plan — on the block format, host
               symbolic, device numeric.
``recompute``  hot phase: new fine-operator values, same structure; every
               level operator is rebuilt through the cached PtAP plans,
               plus ``dinv``, ``lam_max`` and the coarse Cholesky.
``make_recompute`` / ``make_solve``  the hot closures (the reference's
               jitted ones; eager here, with the fault schedule and the
               SpGEMM path bound at the first call, as a trace binds
               them: ``robust.inject.traced``): ``fine values ->
               Hierarchy`` and ``(Hierarchy, b, x0=None) -> CGResult``.
``make_coeff_recompute``  the coefficient hot loop: per-element material
               fields -> device assembly (``fem.device_stiffness``) ->
               ``recompute``; only the two fields cross to the device.
``hier_solve`` hot KSPSolve: AMG-preconditioned CG.

Observability (``repro_torch.obs``): the recompute's stages run in spans
(``recompute/level{i}/smoother_data|ptap``, ``recompute/coarse_chol``);
``make_solve(obs=)`` and ``GAMGSolver(obs=)`` resolve the mode when they
are built, and under ``"counters"`` the solve threads a ``CycleTally``
and reports it in ``CGResult.counters`` with the modeled bytes of its
cycles.  ``GAMGSolver.march`` is the front door of the time march
(``repro_torch.sim``).

Reuse model = PETSc ``-pc_gamg_reuse_interpolation true``: aggregates and
prolongator values stay fixed across recomputes.  The device placement of
the whole hierarchy follows the fine operator's data tensor; its dtypes
follow the setup's ``PrecisionPolicy`` (``precision=``: "f64", "f32",
"bf16"), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (
    Aggregation,
    aggregation_from_device,
    graph_to_ell,
    greedy_aggregate,
    mis_aggregate_rounds,
)
from repro_torch.core.block_csr import (
    BlockCSR,
    BlockELL,
    EllTransposePlan,
    ELLPlan,
    device_array,
    transpose_apply_plan,
    transpose_bcsr,
)
from repro_torch.core.krylov import CGResult, pcg
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.ptap import PtAPCache, ptap_numeric_data, \
    ptap_symbolic
from repro_torch.core.smooth import (
    invert_diag_blocks,
    lambda_max_dinv_a,
    smoothed_prolongator,
)
from repro_torch.core.spmv import spmv_ell
from repro_torch.core.strength import strength_graph
from repro_torch.core.tentative import tentative_prolongator
from repro_torch.core.vcycle import Hierarchy, LevelState, fine_operator, \
    vcycle
from repro_torch.kernels import backend
from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject


@dataclasses.dataclass
class LevelSetup:
    """Cold, host-side symbolic data for one level (structure + plans).

    Under the transpose-free default ``R``/``r_ell`` are ``None`` and
    ``pt`` applies ``P^T`` straight off ``p_ell``'s blocks; under
    ``setup(restriction="stored")`` ``R = transpose_bcsr(P)`` and its ELL
    form ``r_ell`` are kept and ``pt`` is ``None``.  Cold consumers that
    need the stored form either way go through ``restriction_bcsr``."""

    A0: BlockCSR            # level operator at setup time
    P: BlockCSR             # smoothed prolongator (values fixed on reuse)
    ptap_cache: PtAPCache
    a_ell_plan: ELLPlan
    p_ell: BlockELL         # fixed values
    aggr: Aggregation
    omega: torch.Tensor
    n_fine: int
    n_coarse: int
    pt: Optional[EllTransposePlan]
    R: Optional[BlockCSR] = None        # restriction="stored" only
    r_ell: Optional[BlockELL] = None    # restriction="stored" only

    @property
    def diag_rows(self) -> np.ndarray:
        """Block rows that store a diagonal block."""
        rows = self.A0.row_of_nnz()
        return rows[rows == self.A0.indices]

    @property
    def diag_pos(self) -> np.ndarray:
        """Position of each stored diagonal block in the BCSR data."""
        return np.flatnonzero(self.A0.row_of_nnz() == self.A0.indices)


def restriction_bcsr(ls: LevelSetup) -> BlockCSR:
    """The stored-form restriction of a level, the transpose computed on
    demand when the setup is transpose-free (cold consumers only: the hot
    path restricts through ``vcycle.apply_restriction``)."""
    return ls.R if ls.R is not None else transpose_bcsr(ls.P)


@dataclasses.dataclass
class GAMGSetup:
    levels: List[LevelSetup]
    coarse_struct: BlockCSR   # coarsest-level operator (setup values)
    bs_fine: int
    nns_dim: int
    smoother: str
    degree: int
    theta: float
    coarsener: str
    stats: dict
    precision: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy.double)
    # distributed placement hint (PETSc ``-pc_gamg_process_eq_limit``):
    # levels whose equations per rank are at or below it leave the
    # slab-sharded path (``repro_torch.dist.solver.build_dist_gamg``);
    # ``None`` defers to the dist layer's default
    coarse_eq_limit: int | None = None

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def device(self) -> torch.device:
        """Where the hierarchy lives: the device of the operators."""
        return self.coarse_struct.data.device

    @property
    def coarse_rows(self) -> np.ndarray:
        return self.coarse_struct.row_of_nnz()

    @property
    def coarse_cols(self) -> np.ndarray:
        return self.coarse_struct.indices.astype(np.int64)


def setup(A: BlockCSR, B: torch.Tensor, *, theta: float = 0.08,
          max_levels: int = 10, coarse_size: int = 100,
          smoother: str = "chebyshev", degree: int = 2,
          coarsener: str = "mis", precision=None,
          restriction: str = "transpose_free",
          coarse_eq_limit: int | None = None) -> GAMGSetup:
    """Cold GAMG setup on the block format (no scalar expansion).

    ``coarsener="mis"`` (default, as in the reference) aggregates by the
    device Luby-MIS coarsener on ``A.data``'s device, then merges
    undersized aggregates on the host; ``"greedy"`` is the host Vanek
    covering, the paper's coarsener.  ``precision`` is a
    ``PrecisionPolicy`` or a stock name ("f64", "f32", "bf16"); ``None``
    resolves ``REPRO_TORCH_PRECISION`` (default "f64").  The setup math
    runs at the operator's dtype; the policy governs what ``recompute``
    builds and what the solves run at.  ``restriction`` is
    ``"transpose_free"`` (default: no stored ``P^T``, the V-cycle restricts
    off ``p_ell``) or ``"stored"`` (``R = transpose_bcsr(P)`` and its ELL
    form, applied by ``block_spmv`` / ``block_spmm`` on 6x3 blocks at
    level 0).  The hierarchy lives on ``A.data``'s device; ``B`` must be
    on the same device.
    ``stats["mis_rounds"]`` holds the Luby rounds of each MIS level.
    ``coarse_eq_limit`` is the distributed placement hint (equations per
    rank at or below which a level is agglomerated); the single-device
    path ignores it and ``repro_torch.dist.solver.build_dist_gamg``
    consumes it.
    """
    precision = backend.resolve_precision(precision)
    if A.br != A.bc:
        raise ValueError("system operator must have square blocks")
    if restriction not in ("transpose_free", "stored"):
        raise ValueError(f"invalid restriction mode {restriction!r}: "
                         f"expected 'transpose_free' or 'stored'")
    if coarsener not in ("mis", "greedy"):
        raise ValueError(f"invalid coarsener {coarsener!r}: "
                         f"expected 'mis' or 'greedy'")
    if B.device != A.device:
        raise ValueError(f"B on {B.device}, A on {A.device}")
    levels: List[LevelSetup] = []
    Acur, Bcur = A, B
    nns = int(Bcur.shape[1])
    stats = {"level_rows": [A.nbr * A.br], "level_nnzb": [A.nnzb],
             "level_bs": [A.br], "conversions_to_scalar": 0}
    if coarsener == "mis":
        stats["mis_rounds"] = []
    while Acur.nbr > coarse_size and len(levels) < max_levels - 1:
        bs = Acur.br
        graph = strength_graph(Acur, theta)
        if coarsener == "mis":
            idx, mask = graph_to_ell(graph, A.device)
            agg, rounds = mis_aggregate_rounds(idx, mask)
            stats["mis_rounds"].append(rounds)
            aggr = _repair_small_aggregates(aggregation_from_device(agg),
                                            graph, min_size=-(-nns // bs))
        else:
            aggr = greedy_aggregate(graph, min_size=-(-nns // bs))
        if aggr.n_agg >= Acur.nbr:        # no coarsening possible
            break
        Ptent, Bc = tentative_prolongator(aggr, Bcur, bs)
        P, omega, _lam, _plans = smoothed_prolongator(Acur, Ptent)
        cache = ptap_symbolic(Acur, P)
        a_next = ptap_numeric_data(cache, Acur.data, P.data)
        Anext = BlockCSR.from_arrays(cache.ac_plan.indptr,
                                     cache.ac_plan.indices, a_next,
                                     cache.n_coarse)
        p_ell = P.to_ell()
        if restriction == "stored":
            R = transpose_bcsr(P)
            r_ell, pt = R.to_ell(), None
        else:
            R, r_ell = None, None
            pt = transpose_apply_plan(P, p_ell.kmax)
        levels.append(LevelSetup(
            A0=Acur, P=P, ptap_cache=cache, a_ell_plan=Acur.ell_plan(),
            p_ell=p_ell, aggr=aggr, omega=omega, n_fine=Acur.nbr,
            n_coarse=aggr.n_agg, pt=pt, R=R, r_ell=r_ell))
        stats["level_rows"].append(Anext.nbr * Anext.br)
        stats["level_nnzb"].append(Anext.nnzb)
        stats["level_bs"].append(Anext.br)
        Acur, Bcur = Anext, Bc
    return GAMGSetup(levels=levels, coarse_struct=Acur, bs_fine=A.br,
                     nns_dim=nns, smoother=smoother, degree=degree,
                     theta=theta, coarsener=coarsener, stats=stats,
                     precision=precision, coarse_eq_limit=coarse_eq_limit)


def _repair_small_aggregates(aggr: Aggregation, graph, min_size: int
                             ) -> Aggregation:
    """Merge undersized MIS aggregates into neighbours (host, cold): an
    aggregate of fewer than ``min_size`` block rows would leave the
    tentative prolongator rank deficient."""
    agg = aggr.node_to_agg.copy()
    sizes = np.bincount(agg, minlength=aggr.n_agg)
    indptr, indices = graph.indptr, graph.indices
    for i in range(len(agg)):
        a = agg[i]
        if sizes[a] >= min_size:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = nbrs[agg[nbrs] != a] if len(nbrs) else nbrs
        if len(cand):
            t = agg[cand[0]]
            sizes[t] += sizes[a]
            sizes[a] = 0
            agg[agg == a] = t
    uniq, agg = np.unique(agg, return_inverse=True)
    return Aggregation(node_to_agg=agg.astype(np.int64), n_agg=len(uniq))


# ---------------------------------------------------------------------------
# Hot numeric recompute (the state-gated PtAP chain)
# ---------------------------------------------------------------------------

def _at(ell: BlockELL, dtype: torch.dtype) -> BlockELL:
    """``ell`` with its payload at ``dtype`` (itself when it is)."""
    if ell.data.dtype == dtype:
        return ell
    return dataclasses.replace(ell, data=ell.data.to(dtype))


def level_state(ls: LevelSetup, a_data: torch.Tensor,
                policy: PrecisionPolicy | None = None) -> LevelState:
    """Numeric level state from hierarchy-dtype payloads ``a_data``: ELL
    operator, inverted diagonal blocks and ``lam_max(D^-1 A)``.  The
    inversion runs at ``policy.factor_dtype`` and ``D^-1 A`` at the
    accumulator; everything is stored at the hierarchy dtype (an f64
    policy changes nothing)."""
    policy = policy or PrecisionPolicy.double()
    h = policy.hierarchy_dtype
    acc = torch.promote_types(h, policy.accum_dtype)
    dev = a_data.device
    diag = torch.zeros((ls.A0.nbr, ls.A0.br, ls.A0.bc), dtype=a_data.dtype,
                       device=dev)
    diag[device_array(ls, "diag_rows", dev)] = \
        a_data[device_array(ls, "diag_pos", dev)]
    dinv = invert_diag_blocks(diag.to(policy.factor_dtype)).to(h)
    a_ell = ls.a_ell_plan.build(a_data)
    dinva_ell = torch.einsum("nab,nkbc->nkac", dinv.to(acc),
                             a_ell.data.to(acc)).to(h)
    lam = lambda_max_dinv_a(a_ell.indices, dinva_ell.contiguous())
    r_ell = _at(ls.r_ell, h) if ls.r_ell is not None else None
    return LevelState(a_ell=a_ell, p_ell=_at(ls.p_ell, h), dinv=dinv,
                      lam_max=lam, p_t=ls.pt, r_ell=r_ell)


def jittered_cholesky(densef: torch.Tensor, base_scale: float,
                      retry_scale: float) -> torch.Tensor:
    """Dense Cholesky with a one-shot jitter-escalation retry.

    The base factorization adds ``base_scale * trace/n`` to the diagonal.
    A failed factorization (``cholesky_ex`` reports an indefinite or
    rank-deficient matrix in ``info``; one host check) is retried once
    with ``retry_scale * |trace|/n``.  A factor that fails even then is
    returned as NaN, which the Krylov health flags catch within one
    iteration — the reference's NaN-factor contract.
    """
    n = densef.shape[0]
    eye = torch.eye(n, dtype=densef.dtype, device=densef.device)
    tr = torch.trace(densef)
    chol, info = torch.linalg.cholesky_ex(densef + (base_scale * tr / n)
                                          * eye)
    if int(info) == 0:
        return chol
    chol, info = torch.linalg.cholesky_ex(
        densef + (retry_scale * torch.abs(tr) / n) * eye)
    if int(info) == 0:
        return chol
    return torch.full_like(chol, float("nan"))


def coarse_cholesky(dense: torch.Tensor, policy: PrecisionPolicy
                    ) -> torch.Tensor:
    """Jittered dense Cholesky of the coarsest operator at
    ``policy.factor_dtype`` (f64: 1e-12 relative jitter, ``sqrt(eps)`` on
    the retry), stored at the hierarchy dtype."""
    chol = jittered_cholesky(dense.to(policy.factor_dtype),
                             policy.coarse_jitter_scale(),
                             policy.coarse_retry_scale())
    return chol.to(policy.hierarchy_dtype)


def _coarse_dense(setupd: GAMGSetup, a_data: torch.Tensor) -> torch.Tensor:
    """Densify the coarsest operator through cached block positions."""
    cs = setupd.coarse_struct
    dev = a_data.device
    out = torch.zeros((cs.nbr, cs.nbc, cs.br, cs.bc), dtype=a_data.dtype,
                      device=dev)
    out[device_array(setupd, "coarse_rows", dev),
        device_array(setupd, "coarse_cols", dev)] = a_data
    return out.permute(0, 2, 1, 3).reshape(cs.shape)


def recompute(setupd: GAMGSetup, a_fine_data: torch.Tensor, *,
              spgemm_path: str | None = None) -> Hierarchy:
    """Hot numeric hierarchy rebuild: a function of the fine values only.
    ``spgemm_path``: the Galerkin products' path (``None``: the
    ``REPRO_TORCH_SPGEMM_PATH`` knob, read at this call).

    Every level (operator, transfer, ``dinv``, coarse factor) is built and
    stored at the policy's hierarchy dtype, the PtAP chain at that dtype
    with the policy's kernel accumulator.  A mixed policy also keeps a
    krylov-dtype copy of the finest operator, built from the incoming
    values (``Hierarchy.a_fine_ell``), for the outer iteration."""
    policy = setupd.precision
    h = policy.hierarchy_dtype
    a_data = a_fine_data.to(h)
    states = []
    span = obs_trace.span
    for li, ls in enumerate(setupd.levels):
        # level-gated fault site (repro_torch.robust.inject)
        a_data = inject.maybe("hierarchy", a_data, level=li)
        with span(f"recompute/level{li}/smoother_data"):
            states.append(level_state(ls, a_data, policy))
        with span(f"recompute/level{li}/ptap"):
            a_data = ptap_numeric_data(ls.ptap_cache, a_data,
                                       ls.P.data.to(h),
                                       accum_dtype=policy.kernel_accum_dtype,
                                       path=spgemm_path)
    a_data = inject.maybe("hierarchy", a_data, level=len(setupd.levels))
    with span("recompute/coarse_chol"):
        chol = coarse_cholesky(_coarse_dense(setupd, a_data), policy)
    a_fine_ell = None
    if policy.mixed and setupd.levels:
        a_fine_ell = setupd.levels[0].a_ell_plan.build(
            a_fine_data.to(policy.krylov_dtype))
    return Hierarchy(levels=tuple(states), coarse_chol=chol,
                     a_fine_ell=a_fine_ell)


def _spgemm_knob(setupd: GAMGSetup):
    """The knobs a recompute closure binds at its first call: the SpGEMM
    path then resolved (a jitted reference closure keeps the path it was
    traced on)."""
    return lambda: dict(spgemm_path=backend.resolve_spgemm_path(
        setupd.device))


def make_recompute(setupd: GAMGSetup):
    """The hot recompute closure ``a_fine_data -> Hierarchy``.  The
    reference jits it; here the fault schedule and the SpGEMM path in
    force at its first call hold for every later call
    (``robust.inject.traced``)."""
    def hot_recompute(a_fine_data, *, spgemm_path):
        return recompute(setupd, a_fine_data, spgemm_path=spgemm_path)

    return inject.traced(hot_recompute, _spgemm_knob(setupd))


def _solve_fn(setupd: GAMGSetup, rtol: float, maxiter: int, mode: str):
    """The solve of a resolved observability ``mode``: ``hier_solve``
    itself, or under ``"counters"`` the same solve threading a fresh
    ``CycleTally`` whose ``modeled_bytes`` are the cycles it counted times
    ``vcycle_traffic``'s bytes a cycle at the hierarchy's itemsize."""
    if not obs_trace.counters_enabled(mode):
        def solve(hier: Hierarchy, b: torch.Tensor,
                  x0: torch.Tensor | None = None) -> CGResult:
            return hier_solve(setupd, hier, b, x0, rtol=rtol,
                              maxiter=maxiter)
        return solve

    from repro_torch.obs.model import cycle_bytes
    per_cycle = cycle_bytes(setupd)
    smoother, degree = setupd.smoother, setupd.degree

    def counted_solve(hier: Hierarchy, b: torch.Tensor,
                      x0: torch.Tensor | None = None) -> CGResult:
        def apply_a(x):
            return spmv_ell(fine_operator(hier), x)

        def apply_m(r, tl):
            return vcycle(hier, r, smoother=smoother, degree=degree,
                          tally=tl)

        res = pcg(apply_a, apply_m, b, x0=x0, rtol=rtol, maxiter=maxiter,
                  precond_dtype=setupd.precision.smoother_dtype,
                  tally=obs_trace.zero_tally(setupd.n_levels, b.device))
        return res._replace(counters=obs_trace.attach_model_bytes(
            res.counters, per_cycle))

    return counted_solve


def make_solve(setupd: GAMGSetup, rtol: float = 1e-8, maxiter: int = 200,
               obs: str | None = None):
    """The hot KSPSolve closure ``(Hierarchy, b, x0=None) -> CGResult``:
    AMG-preconditioned CG, ``x0`` warm-starting it.  ``obs`` (None: the
    ``use`` scope, else ``REPRO_TORCH_OBS``) is resolved here and holds
    for every call: ``"counters"`` fills ``CGResult.counters``; ``"off"``
    dispatches exactly ``hier_solve``'s ops."""
    mode = obs_trace.resolve(obs)
    return inject.traced(_solve_fn(setupd, rtol, maxiter, mode), obs=mode)


def _check_assembler(setupd: GAMGSetup, assembler) -> None:
    """The assembler's COO plan must produce the setup's fine operator: a
    mismatched plan would "converge" against a garbage operator."""
    nnzb = setupd.levels[0].A0.nnzb if setupd.levels \
        else setupd.coarse_struct.nnzb
    if assembler.plan.nnzb != nnzb:
        raise ValueError(
            f"assembler plan does not match the setup's fine operator: "
            f"plan has {assembler.plan.nnzb} output blocks, the fine "
            f"level has {nnzb}")
    if assembler.device != setupd.device:
        raise ValueError(f"assembler on {assembler.device}, hierarchy on "
                         f"{setupd.device}")


def make_coeff_recompute(setupd: GAMGSetup, assembler):
    """Coefficient hot path: ``(E, nu) -> Hierarchy``.

    Device FEM assembly (batched quadrature -> cached blocked-COO scatter,
    ``fem.device_stiffness.DeviceAssembler.coo_data``) followed by the
    state-gated PtAP recompute, all on the hierarchy's device: given
    fields already there, nothing crosses from the host."""
    _check_assembler(setupd, assembler)

    def coeff_recompute(E, nu, *, spgemm_path):
        return recompute(setupd, assembler.coo_data(E, nu),
                         spgemm_path=spgemm_path)

    return inject.traced(coeff_recompute, _spgemm_knob(setupd))


def make_coeff_solve(setupd: GAMGSetup, assembler, rtol: float = 1e-8,
                     maxiter: int = 200):
    """Fused march step: ``(E, nu, b, x0) -> CGResult`` — device
    assembly, the recompute and the warm-started AMG-PCG solve (``x0``
    the previous step's iterate; zeros for a cold start)."""
    _check_assembler(setupd, assembler)

    def coeff_solve(E, nu, b, x0, *, spgemm_path):
        hier = recompute(setupd, assembler.coo_data(E, nu),
                         spgemm_path=spgemm_path)
        return hier_solve(setupd, hier, b, x0, rtol=rtol, maxiter=maxiter)

    return inject.traced(coeff_solve, _spgemm_knob(setupd))


def hier_solve(setupd: GAMGSetup, hier: Hierarchy, b: torch.Tensor,
               x0: torch.Tensor | None = None, *, rtol: float = 1e-8,
               maxiter: int = 200) -> CGResult:
    """AMG-PCG solve on a hierarchy; ``x0`` warm-starts CG."""
    def apply_a(x):
        return spmv_ell(fine_operator(hier), x)

    def apply_m(r):
        return vcycle(hier, r, smoother=setupd.smoother,
                      degree=setupd.degree)

    return pcg(apply_a, apply_m, b, x0=x0, rtol=rtol, maxiter=maxiter,
               precond_dtype=setupd.precision.smoother_dtype)


class GAMGSolver:
    """PETSc-shaped front door: setup once, re-solve many times.  Runs on
    the device of ``A.data``.  ``obs`` (None: the ``use`` scope, else
    ``REPRO_TORCH_OBS``) is resolved at construction; the recomputes and
    solves run under it, and the panel solves take it too."""

    def __init__(self, A: BlockCSR, B: torch.Tensor, *, rtol: float = 1e-8,
                 maxiter: int = 200, obs: str | None = None, **opts):
        self.rtol, self.maxiter = rtol, maxiter
        self.obs = obs_trace.resolve(obs)
        self.setup_data = setup(A, B, **opts)
        self._solve = _solve_fn(self.setup_data, rtol, maxiter, self.obs)
        with obs_trace.use(self.obs):
            self.hierarchy = recompute(self.setup_data, A.data)
        self.n_recomputes = 0
        self.assembler = None

    def update_operator(self, a_fine_data: torch.Tensor) -> None:
        """Hot path: new operator values, same structure (Newton step)."""
        with obs_trace.use(self.obs):
            self.hierarchy = recompute(self.setup_data, a_fine_data)
        self.n_recomputes += 1

    def bind_assembler(self, assembler) -> None:
        """Attach a ``fem.device_stiffness.DeviceAssembler``, enabling
        ``update_coefficients``; a plan that does not match the fine
        operator raises here."""
        self._coeff_recompute = make_coeff_recompute(self.setup_data,
                                                     assembler)
        self.assembler = assembler

    def update_coefficients(self, E, nu) -> None:
        """Hot path: new material fields (per-element arrays or scalars),
        same mesh and structure — device assembly, then the PtAP chain."""
        if self.assembler is None:
            raise ValueError(
                "update_coefficients needs a bound DeviceAssembler: "
                "call bind_assembler(problem.assembler) (device assembly "
                "path) first")
        E, nu = self.assembler.as_fields(E, nu)
        self.hierarchy = self._coeff_recompute(E, nu)
        self.n_recomputes += 1

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None
              ) -> CGResult:
        """Solve; ``x0`` warm-starts CG from a prior iterate."""
        with obs_trace.use(self.obs):
            return self._solve(self.hierarchy, b, x0)

    def solve_many(self, B: torch.Tensor, x0: torch.Tensor | None = None):
        """Panel solve: ``B (n, k)`` -> ``BlockCGResult`` (per-column
        masked PCG, one operator stream for all k columns).  ``x0``
        warm-starts every column from a prior ``(n, k)`` panel.  Streams
        of requests go through ``repro_torch.multirhs.AMGSolveServer``."""
        from repro_torch.multirhs.block_krylov import make_block_solve
        solve = make_block_solve(self.setup_data, rtol=self.rtol,
                                 maxiter=self.maxiter, obs=self.obs)
        return solve(self.hierarchy, B, x0)

    def march(self, prob, scenario, cfg, **kw):
        """Front door of the time march (``repro_torch.sim.driver
        .march``): quasi-static coefficient evolution through fused
        assembly, recompute and warm-started solve steps, re-coarsened at
        staleness boundaries.  ``prob`` is the assembled problem this
        solver was built from (device assembly path); ``setup_opts``
        defaults to ``{}`` (``setup``'s defaults), as the reference's."""
        from repro_torch.sim.driver import march as _march
        kw.setdefault("setup_opts", {})
        return _march(prob, scenario, cfg, **kw)
