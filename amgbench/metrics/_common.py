"""Shared arithmetic of the per-layer readers.  A reader gets the run's
context and returns its number, or None when the run gave it nothing to
read."""
import statistics


def mean_ms(values):
    return 1e3 * statistics.fmean(values) if values else None


def roofline_share(ctx):
    """Least time of the traced window's sparse work over the device's
    busy time in that window, in percent."""
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0 or not ctx.get("least_time_s"):
        return None
    return 100.0 * ctx["least_time_s"] / tr.busy_s


def idle_share(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
