"""``model_mfu``: the whole step's share of the card's peak, in %: the
configuration's FLOPs a frame (its ``flops(cfg)``) times the frames the
sink received in the traced window, over the window's seconds, over the
published dense peak of the configuration's dtype. It bounds every
kernel's share from above: a kernel taken off the path leaves its own
roofline silent, not this."""

from h100bench import peaks


def read(ctx):
    if not ctx.window_frames or ctx.slice is None:
        return None
    rate = ctx.program.flops(ctx.cfg) * ctx.window_frames / ctx.window_s
    return 100.0 * rate / peaks.FLOPS[ctx.cfg["dtype"]]
