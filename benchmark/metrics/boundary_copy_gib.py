"""The bytes the device loop copies at a call's boundary, in GiB a call:
``device_loop.STATS.copy_bytes`` (the state copied into the graph's static
state before the replays and cloned out of it on return) over the stamped
calls of the timed path (``stamped.phase``)."""


def read(ctx):
    stamps = getattr(ctx, "stamps", None)
    if not stamps or not stamps["copy_bytes"]:
        return None
    return stamps["copy_bytes"] / stamps["calls"] / 2**30
