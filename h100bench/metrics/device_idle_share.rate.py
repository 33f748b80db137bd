"""``device_idle_share.rate``: ``device_idle_share`` in a cell paced by
its arrivals, where it moves the latency tail rather than the rate."""

from h100bench import cells


def read(ctx):
    return cells.load_metric("device_idle_share").read(ctx)
