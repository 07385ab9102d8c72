"""Least H100 time of the traced hot steps' sparse work (``amgbench.work``)
over the device's busy time in those steps, in percent."""
from amgbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx)
