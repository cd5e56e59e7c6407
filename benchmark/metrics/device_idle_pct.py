"""The device's idle share of whole replayed calls: 1 - the union of its
kernel, copy and memset intervals over the profiled window's wall time."""


def read(ctx):
    w = ctx.profiled
    return 100.0 * (1.0 - w.busy_s() / w.wall_s) if w.device else None
