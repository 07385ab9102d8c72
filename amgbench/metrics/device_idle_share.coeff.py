"""Share of the traced hot steps' wall time in which no operation ran on
the device (``torch.profiler``), in percent."""
from amgbench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx)
