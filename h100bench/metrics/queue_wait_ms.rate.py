"""``queue_wait_ms.rate``: ``queue_wait_ms`` in a cell paced by its
arrivals, where it moves the latency tail rather than the rate."""

from h100bench import cells


def read(ctx):
    return cells.load_metric("queue_wait_ms").read(ctx)
