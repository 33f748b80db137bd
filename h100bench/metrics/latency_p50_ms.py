"""``latency_p50_ms``: the median, over every frame of an open loop due
inside the window that reached its sink, of the time from the frame's
due time to its arrival. Nothing to read in a closed loop."""

from h100bench import stats


def read(ctx):
    return stats.latency_quantile(ctx, 50)
