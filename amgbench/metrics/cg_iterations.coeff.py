"""Mean CG iterations (CGResult.iters) a hot step over the window."""
import statistics


def read(ctx):
    its = ctx.get("cg_iterations")
    return statistics.fmean(its) if its else None
