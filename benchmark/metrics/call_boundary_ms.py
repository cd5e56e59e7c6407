"""The device loop's call boundary: the device time from the stamp that
closes one call's last ``loop/replay`` to the stamp that opens the next
call's first, the mean over the boundaries between the stamped calls of the
timed path (``stamped.phase``, ``tracing.boundary_attribution``): the
copies into and out of the graph's static state, and the time the card
waits on the host between two calls."""


def read(ctx):
    stamps = getattr(ctx, "stamps", None)
    if not stamps or stamps["boundary"] is None:
        return None
    return stamps["boundary"]["boundary_ms"]
