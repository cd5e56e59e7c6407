"""The whole step's share of the chip's roofline: the least time a step
could take (``counts.step.step_bound``, the same work whichever route or
kernels run it) over the measured wall time a step of the window."""

from benchmark.counts.step import step_bound


def read(ctx):
    if not ctx.steps:
        return None
    ms, _ = step_bound(ctx.shape)
    return 100.0 * ms / (1e3 * ctx.wall_s / ctx.steps)
