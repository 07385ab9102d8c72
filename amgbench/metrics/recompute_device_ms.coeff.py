"""Device ms a traced hot step of the kernels launched under the
program's ``recompute/*`` spans (the Galerkin chain, the smoother data
and the coarse factor)."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_units")
    if tr is None or not n or tr.recompute_s <= 0:
        return None
    return 1e3 * tr.recompute_s / n
