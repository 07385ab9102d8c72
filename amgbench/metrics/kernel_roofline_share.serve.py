"""Least H100 time of the traced panels' sparse work (``amgbench.work``)
over the device's busy time in those panels, in percent."""
from amgbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx)
