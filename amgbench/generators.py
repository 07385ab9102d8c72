"""The two traffic generators, and the interface of every loop.  A traffic
file names its generator and holds every parameter it reads; a new mix of
either kind is a new data file.  A generator that is not in
``GENERATORS`` is the class ``Loop`` of ``loops/<generator>.py`` under
the harness's folder, a new kind of traffic is a new file there.

A loop is built as ``Loop(cfg, traffic, seed, device)``: the
configuration's and the traffic's parsed files, the run's seed and the
card (``cuda:r`` on rank ``r``).  The harness then calls, in order:

- ``warmup()``: every shape the window uses, once; set-up ends after it;
- ``window(seconds, spans)``: the measured window, until ``seconds`` have
  passed (``spans``: a traced run, which may synchronise inside a unit to
  time its parts);
- ``traced(n, tracer)`` (``--trace 1`` on a card): ``tracer(units)`` of a
  function ``units()`` that runs ``n`` more units, ending synchronised;
  returns what ``tracer`` returned;
- ``end_to_end()``: the cell's end-to-end metrics but ``setup_s`` and
  ``peak_device_gib``, by name; ``attempted`` and ``failed``, counts;
- ``layer_context(trace)`` (``--trace 1``): the dict the per-layer
  readers of ``metrics/`` read, ``trace`` the window's ``Trace`` or None;
- ``release()``: drops the program's state; returns what judging needs;
- ``make_judge(device)``: the reference side, with a ``worst`` dict of
  the largest gap of each compared number (names from ``limits.json``);
- ``judge(judge, kept)``: judges what ``release`` returned.

A loop file may also hold ``FAULTS``: fault name -> a function that
returns a context manager which breaks the timed path while the window
runs (``control.py --fault <name>`` plants it, in every rank process of
a cell on several chips; it may act on one rank alone).  ``control.py
--precision`` sets ``REPRO_TORCH_PRECISION`` there after the cell's own
knobs.

A loop of a cell on several chips runs once on every rank, in a process
of its own, and reads its rank and world from the default
``torch.distributed`` group, which the harness has set up
(``repro_torch.dist.comm.RankComm()`` takes that group as it is).  It
keeps its ranks in lockstep through its own collectives, the window's
end too: every rank has to run the same number of units.  The lead rank
(0) gives the end-to-end metrics, ``attempted`` and the layers' readings;
every rank counts its own ``failed``, runs the traced units under the
profiler and judges its own share.

``coefficient_loop``: one closed-loop stream of hot steps on a hierarchy
set up once on the uniform material: each step brings new per-element
fields (a stiff sphere whose centre is drawn from the seed), then
``GAMGSolver.update_coefficients`` and ``GAMGSolver.solve`` of the body
force from zero, ending synchronised.

``closed_loop_serve``: ``clients`` closed-loop clients against one fixed
operator: each round the harness submits every client's next request to
``AMGSolveServer`` and calls ``flush``; each request's latency runs on
the harness's clock from its ``submit`` to the return of that ``flush``.
Right-hand sides are standard normal rows of a pool made from the seed in
set-up and cycled, so no two columns of a panel are equal.
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from amgbench import work
from amgbench.reference import fem
from amgbench.reference.judge import Judge


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _op(ell) -> work.Op:
    return work.Op(nvalid=int(ell.mask.sum()), br=ell.br, bc=ell.bc,
                   nbr=ell.nbr, nbc=ell.nbc)


def shapes(setupd, hier, coo_input: int) -> work.Shapes:
    """The work counts' view of a hierarchy (structure only)."""
    levels = []
    ops = [_op(lv.a_ell) for lv in hier.levels]
    for i, lv in enumerate(hier.levels):
        plen = lv.p_ell.mask.sum(1)
        pairs = int(plen[lv.a_ell.indices.long()][lv.a_ell.mask].sum())
        ac = (ops[i + 1].nvalid if i + 1 < len(ops)
              else setupd.coarse_struct.nnzb)
        levels.append(work.Level(A=ops[i], P=_op(lv.p_ell), ap_pairs=pairs,
                                 ac_blocks=ac))
    krylov = hier.a_fine_ell if hier.a_fine_ell is not None \
        else hier.levels[0].a_ell
    degree = setupd.degree if setupd.smoother == "chebyshev" else 2
    return work.Shapes(levels=tuple(levels),
                       coarse_n=int(hier.coarse_chol.shape[0]),
                       krylov=_op(krylov),
                       itemsize=hier.levels[0].a_ell.data.element_size(),
                       krylov_itemsize=krylov.data.element_size(),
                       coo_input=coo_input, smoother_steps=degree)


class _WholeCube:
    """A loop over one whole Q1 cube on one device: its judge is the
    reference of that cube, on the program's set-up aggregates."""

    def make_judge(self, device) -> Judge:
        return Judge(self.econf.m, self.econf.E, self.econf.nu,
                     self.aggregates, device)


class CoefficientLoop(_WholeCube):
    """Hot steps: new fields, ``update_coefficients``, ``solve``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.configs.elasticity import ElasticityConfig
        self.t, self.device = traffic, device
        self.econf = ElasticityConfig(**cfg["elasticity"])
        self.prob, self.solver = self.econf.build(device)
        m = self.econf.m
        inc = traffic["inclusion"]
        self.centroids = torch.as_tensor(fem.element_centroids(m),
                                         device=device)
        gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        lo, hi = inc["center_low"], inc["center_high"]
        n = traffic["max_steps"] + 1
        self.centres = lo + (hi - lo) * torch.rand(
            (n, 3), generator=gen, dtype=torch.float64, device=device)
        self.r2 = inc["radius"] ** 2
        # (matrix, inclusion) values, picked by a 0/1 index an element
        self.E, self.nu = (torch.tensor(inc[k], dtype=torch.float64,
                                        device=device) for k in ("E", "nu"))
        self.judge_at = random.Random(seed).randrange(traffic["judge_first"])
        self.kept = []
        self.steps = []          # (iters, converged, update_s, solve_s)
        self.traced_iters = []
        sd = self.solver.setup_data
        self.shapes = shapes(sd, self.solver.hierarchy,
                             len(self.prob.coo_plan.perm))
        self.aggregates = [ls.aggr.node_to_agg for ls in sd.levels]

    def fields(self, i: int):
        inside = ((self.centroids - self.centres[i]) ** 2).sum(1) <= self.r2
        inside = inside.to(torch.int64)
        return self.E[inside], self.nu[inside]

    def step(self, i: int, spans: bool = False):
        E, nu = self.fields(i)
        t0 = time.perf_counter()
        self.solver.update_coefficients(E, nu)
        if spans:
            sync(self.device)
        t1 = time.perf_counter()
        res = self.solver.solve(self.prob.b)
        sync(self.device)
        t2 = time.perf_counter()
        return res, E, nu, t1 - t0, t2 - t1

    def warmup(self) -> None:
        self.step(len(self.centres) - 1)

    def window(self, seconds: float, spans: bool) -> None:
        """Run steps until ``seconds`` have passed; ``spans`` synchronises
        between the update and the solve, to time each."""
        i = 0
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            if i >= len(self.centres) - 1:
                raise RuntimeError("max_steps reached inside the window")
            self._record(i, *self.step(i, spans))
            i += 1
        self.window_s = elapsed
        self.last = (i - 1, self.solver.hierarchy, self._last_x,
                     *self.fields(i - 1))
        self.next = i

    def traced(self, n: int, tracer):
        """``n`` more steps, after the window, under ``tracer``."""
        self.traced_iters, first = [], self.next
        self.next += n

        def units():
            for j in range(first, first + n):
                self.traced_iters.append(self.step(j)[0].iters)
        return tracer(units)

    def _record(self, i, res, E, nu, update_s, solve_s):
        self.steps.append((res.iters, bool(res.converged), update_s,
                           solve_s))
        self._last_x = res.x
        if i == self.judge_at:
            self.kept.append((i, self.solver.hierarchy, res.x, E, nu))

    def end_to_end(self) -> dict:
        return {"hot_step_ms": 1e3 * self.window_s / len(self.steps)}

    @property
    def attempted(self) -> int:
        return len(self.steps)

    @property
    def failed(self) -> int:
        return sum(1 for s in self.steps if not s[1])

    def layer_context(self, trace) -> dict:
        w = work.Work()
        for iters in self.traced_iters:
            work.coefficient_update(w, self.shapes)
            work.cg_solve(w, self.shapes, iters)
        return dict(
            trace=trace, least_time_s=w.seconds,
            traced_units=len(self.traced_iters),
            coeff_update_s=[s[2] for s in self.steps],
            solve_s=[s[3] for s in self.steps],
            cg_iterations=[s[0] for s in self.steps])

    def release(self):
        """Drop the program's state but what the judging reads."""
        kept = self.kept + [self.last]
        self.kept = self.last = self.solver = self.prob = self._last_x = None
        return kept

    def judge(self, judge, kept) -> None:
        seen = set()
        for i, hier, x, E, nu in kept:
            if i in seen:
                continue
            seen.add(i)
            A = judge.hierarchy(hier, E, nu)
            judge.solution(A, fem.body_force(self.econf.m, self.device), x)


class ClosedLoopServe(_WholeCube):
    """Rounds of one request a client through ``submit`` / ``flush``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.configs.elasticity import ElasticityConfig
        from repro_torch.core import gamg
        from repro_torch.fem.assemble import assemble_elasticity
        from repro_torch.multirhs import AMGSolveServer
        self.t, self.device = traffic, device
        c = self.econf = ElasticityConfig(**cfg["elasticity"])
        prob = assemble_elasticity(c.m, order=c.order, E=c.E, nu=c.nu,
                                   path=c.assembly, device=device)
        sd = gamg.setup(prob.A, prob.B, theta=c.theta, smoother=c.smoother,
                        degree=c.degree, coarse_size=c.coarse_size,
                        coarsener=c.coarsener,
                        coarse_eq_limit=c.coarse_eq_limit)
        self.server = AMGSolveServer(sd, prob.A.data,
                                     buckets=traffic["buckets"], rtol=c.rtol,
                                     maxiter=c.maxiter, record_history=False)
        self.shapes = shapes(sd, self.server.hierarchy,
                             len(prob.coo_plan.perm))
        self.aggregates = [ls.aggr.node_to_agg for ls in sd.levels]
        del prob
        self.clients = traffic["clients"]
        gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        self.pool = torch.randn((traffic["pool"], self.server.n),
                                generator=gen, dtype=torch.float64,
                                device=device).cpu().numpy()
        self.rng = random.Random(seed)
        self.sample = []           # reservoir of (request no., pool row, x)
        self.latencies, self.iters, self.traced_iters = [], [], []
        self.failures = 0
        self.requests = 0

    def round(self, r: int):
        rows = [(self.clients * r + c) % len(self.pool)
                for c in range(self.clients)]
        t_sub = []
        for row in rows:
            t_sub.append(time.perf_counter())
            self.server.submit(self.pool[row])
        reports = self.server.flush()
        t_done = time.perf_counter()
        return rows, t_sub, reports, t_done

    def warmup(self) -> None:
        self.round(0)
        self.solve_wall0 = self._solve_wall()

    def _solve_wall(self):
        snap = self.server.metrics().solve_wall.snapshot()
        return snap["count"], snap["sum"]

    def _record(self, rows, t_sub, reports, t_done):
        for row, ts, rp in zip(rows, t_sub, reports):
            self.latencies.append(t_done - ts)
            self.iters.append(rp.iters)
            if rp.status != "ok":
                self.failures += 1
            n = self.requests
            self.requests += 1
            keep = self.t["judge_requests"]
            if len(self.sample) < keep:
                self.sample.append((n, row, rp.x))
            else:
                j = self.rng.randrange(n + 1)
                if j < keep:
                    self.sample[j] = (n, row, rp.x)

    def window(self, seconds: float, spans: bool) -> None:
        """Run rounds until ``seconds`` have passed."""
        r = 0
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            self._record(*self.round(r))
            r += 1
        self.window_s = elapsed
        self.next = r
        count, total = self._solve_wall()
        self.panel_solve_s = (total - self.solve_wall0[1]) \
            / max(count - self.solve_wall0[0], 1)

    def traced(self, n: int, tracer):
        """``n`` more rounds, after the window, under ``tracer``."""
        self.traced_iters, first = [], self.next
        self.next += n

        def units():
            for r in range(first, first + n):
                reports = self.round(r)[2]
                self.traced_iters.append(max(rp.iters for rp in reports))
        return tracer(units)

    def end_to_end(self) -> dict:
        p95 = statistics.quantiles(self.latencies, n=20,
                                   method="inclusive")[18]
        return {"solves_per_s": self.requests / self.window_s,
                "request_p95_ms": 1e3 * p95}

    @property
    def attempted(self) -> int:
        return self.requests

    @property
    def failed(self) -> int:
        return self.failures

    def layer_context(self, trace) -> dict:
        w = work.Work()
        for iters in self.traced_iters:
            work.cg_solve(w, self.shapes, iters, k=self.clients)
        return dict(
            trace=trace, least_time_s=w.seconds,
            traced_units=len(self.traced_iters),
            panel_solve_s=self.panel_solve_s,
            cg_iterations=self.iters,
            request_latency_s=self.latencies)

    def release(self):
        kept = (self.server.hierarchy, self.sample)
        self.server = None
        return kept

    def judge(self, judge, kept) -> None:
        hier, sample = kept
        A = judge.hierarchy(hier)
        for _, row, x in sample:
            judge.solution(A, torch.as_tensor(self.pool[row],
                                              device=self.device), x)


GENERATORS = {"coefficient_loop": CoefficientLoop,
           "closed_loop_serve": ClosedLoopServe}
