"""eval_latency_p95_ms: the 95th percentile (nearest rank) over every
step of the window, each timed from its start until its boxes are on the
host; one client, closed loop."""
import math


def read(ctx):
    if ctx.mode != "eval" or not ctx.window.lat_ms:
        return None
    lat = sorted(ctx.window.lat_ms)
    return lat[math.ceil(0.95 * len(lat)) - 1]
