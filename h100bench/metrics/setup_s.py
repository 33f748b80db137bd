"""``setup_s``: seconds from the process's start to the window's
opening: imports, weights, the warm-up's eager first window and
capture, and the preroll (in a checkout's first run, the kernels'
builds too)."""


def read(ctx):
    return ctx.setup_s
