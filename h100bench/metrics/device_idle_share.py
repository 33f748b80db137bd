"""``device_idle_share``: the share of the profiled slice's wall time in
which no operation ran on the device, in %."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.wall_us <= 0 or sl.busy_us <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_us / sl.wall_us)
