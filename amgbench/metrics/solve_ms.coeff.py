"""Mean wall time of ``solve`` over the window's hot steps, on the
harness's clock, synchronised after the call."""
from amgbench.metrics._common import mean_ms


def read(ctx):
    return mean_ms(ctx.get("solve_s"))
