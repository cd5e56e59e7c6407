"""The device time of the eager buoyancy (``step/teos10``) a replayed step,
by the port's tracer: the span's device stamps, which run at every replay of
the captured graphs, summed over the stamped calls of the timed path
(``stamped.phase``) over their replayed steps. The launch gaps between its
kernels inside the graph count."""


def read(ctx):
    stamps = getattr(ctx, "stamps", None)
    if not stamps or "step/teos10" not in stamps["spans"]:
        return None
    return stamps["spans"]["step/teos10"]["total_ms"] / stamps["steps"]
