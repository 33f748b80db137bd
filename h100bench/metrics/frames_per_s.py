"""``frames_per_s``: the frames that reached the sinks inside the window,
over the window's seconds (every arrival, of every branch)."""


def read(ctx):
    if not ctx.window_s:
        return None
    n = sum(1 for t in ctx.arrivals if ctx.t0 <= t < ctx.t1)
    return n / ctx.window_s
