"""``latency_p95_ms``: the 95th percentile, over every frame of an open
loop due inside the window that reached its sink, of the time from the
frame's due time to its arrival (frames that never arrived are the
run's ``failed``). Nothing to read in a closed loop."""

from h100bench import stats


def read(ctx):
    return stats.latency_quantile(ctx, 95)
