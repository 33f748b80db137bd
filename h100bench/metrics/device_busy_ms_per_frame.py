"""``device_busy_ms_per_frame``: the union of the device's intervals in
the profiled slice (every kernel and copy; the model, B1, the decoder's
device half), in ms, over the frames that reached the sink in it."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.frames or sl.busy_us <= 0:
        return None
    return sl.busy_us / 1e3 / sl.frames
