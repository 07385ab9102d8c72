"""Mean CG iterations a request (each column's own count) over the
window."""
import statistics


def read(ctx):
    its = ctx.get("cg_iterations")
    return statistics.fmean(its) if its else None
