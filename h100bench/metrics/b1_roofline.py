"""``b1_roofline``: kernel B1's share of its roofline, in %: the least
time a launch could take (``counts/normalize_chain_kernel.py``, from the
launch's elements: a frame's times the mix's batch) over B1's device
time a launch in the profiled slice, by kernel name."""

KERNEL = "normalize_chain_kernel"


def read(ctx):
    sl = ctx.slice
    if sl is None or KERNEL not in getattr(ctx.program, "KERNELS", {}):
        return None
    got = sl.op_time(KERNEL)
    if got is None:
        return None
    us, launches = got
    elements = ctx.program.KERNELS[KERNEL](ctx.cfg) * int(ctx.traffic["batch"])
    bound = ctx.count(KERNEL).bound_seconds(elements)
    return 100.0 * bound / (us / launches / 1e6)
