"""The control and the planted faults of the judging: a cell run with the
program's own lower-precision path switched on, or with its timed path
broken underneath, must come out not correct.

    python3 amgbench/control.py --workload <name> --seeds 1 2 3 \
        --seconds <s> (--precision f32 | --fault <name>)

Prints one JSON line a seed: ``correct`` and every compared number.
``FAULTS`` names the faults each of the two built-in loops can have; a
loop of ``loops/<generator>.py`` brings its own as a ``FAULTS`` dict in
that file (``faults``).  A cell on several chips runs through the rank
processes, as ``run.py`` runs it, with the precision and the fault set
in every rank.  The tests run them on the CPU at a small size.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def state_unchanged():
    """Coefficient updates keep the old hierarchy."""
    from repro_torch.core.gamg import GAMGSolver
    return _patched(GAMGSolver, "update_coefficients",
                    lambda old: lambda self, E, nu: None)


def fields_half_left_out():
    """Coefficient updates leave out the second half of the elements'
    new fields: those take the mean of the first half."""
    from repro_torch.core.gamg import GAMGSolver

    def update(old):
        def halved(self, E, nu):
            E, nu = E.clone(), nu.clone()
            h = len(E) // 2
            E[h:], nu[h:] = E[:h].mean(), nu[:h].mean()
            return old(self, E, nu)
        return halved
    return _patched(GAMGSolver, "update_coefficients", update)


def panel_half_left_out():
    """Each panel's second half of columns comes back unsolved (zeros)."""
    from repro_torch.multirhs.server import AMGSolveServer

    def flush(old):
        def halved(self):
            reports = old(self)
            half = len(reports) // 2
            return reports[:half] + [r._replace(x=0.0 * r.x)
                                     for r in reports[half:]]
        return halved
    return _patched(AMGSolveServer, "flush", flush)


def solution_altered():
    """One entry of every solution is changed by 1% where it is made."""
    from repro_torch.core.gamg import GAMGSolver

    def solve(old):
        def altered(self, b, x0=None):
            res = old(self, b, x0)
            x = res.x.clone()
            x[len(x) // 3] *= 1.01
            return res._replace(x=x)
        return altered
    return _patched(GAMGSolver, "solve", solve)


def answer_altered():
    """One entry of every served answer is changed by 1%."""
    from repro_torch.multirhs.server import AMGSolveServer

    def flush(old):
        def altered(self):
            out = []
            for r in old(self):
                x = r.x.copy()
                x[len(x) // 3] *= 1.01
                out.append(r._replace(x=x))
            return out
        return altered
    return _patched(AMGSolveServer, "flush", flush)


FAULTS = {"coefficient_loop": {"state_unchanged": state_unchanged,
                               "half_left_out": fields_half_left_out,
                               "answer_altered": solution_altered},
          "closed_loop_serve": {"half_left_out": panel_half_left_out,
                                "answer_altered": answer_altered}}


def faults(generator, base=None):
    """The faults, by name, of the loop a traffic file's ``generator``
    names: each a function that returns the context manager which breaks
    the timed path while the window runs."""
    from amgbench import harness
    if generator in FAULTS:
        return FAULTS[generator]
    return getattr(harness.loop_file(generator, base or harness.HERE),
                   "FAULTS", {})


def run(workload, seed, seconds, precision=None, fault=None, root=ROOT,
        device=None, base=None, watchdog_s=None):
    """One cell run under the control or a fault; the result object.
    ``base`` (the harness's folder) and ``watchdog_s`` are for the
    tests."""
    from amgbench import harness
    base = base or harness.HERE
    cell = harness.load_cell(root, workload, base)
    env = {"REPRO_TORCH_PRECISION": precision} if precision else {}
    t_start = time.perf_counter()
    if cell.chips > 1:
        return harness.run_ranks(cell, seed, seconds, False, t_start,
                                 device=device, src=root / "src", base=base,
                                 watchdog_s=watchdog_s, fault=fault,
                                 env=env)
    harness.prepare_env(cell)
    os.environ.update(env)
    broken = faults(cell.traffic["generator"], base)[fault] if fault \
        else contextlib.nullcontext
    return harness.run_cell(cell, seed, seconds, False, t_start,
                            device=device, src=root / "src", base=base,
                            window_context=broken)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--precision", choices=("f32", "bf16"))
    g.add_argument("--fault")
    a = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in a.seeds:
        out = run(a.workload, seed, a.seconds, a.precision, a.fault)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "precision": a.precision, "fault": a.fault,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)


if __name__ == "__main__":
    main()
