"""The 95th percentile of the window's request latencies, on the
harness's clock from submit to the return of the flush that served it."""
import statistics


def read(ctx):
    lat = ctx.get("request_latency_s")
    if not lat or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
