"""``fence_wait_ms``: the dispatch window's fence (``pipeline/dispatch.py``,
``nns_filter_fence_wait_seconds``): its sum over its count inside the
traced window, in ms a fence."""


def read(ctx):
    seconds, fences = ctx.fence
    return seconds / fences * 1e3 if fences else None
