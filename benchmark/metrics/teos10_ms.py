"""The device busy time of the eager buoyancy (``step/teos10``) a step: the
union of the kernels inside the range in steps launched from the host."""


def read(ctx):
    return ctx.spans.get("step/teos10")
