"""The device memory that the captured graphs' private pools reserved
(``models.device_loop.STATS.pool_bytes``), in GiB."""


def read(ctx):
    pool = ctx.stats["pool_bytes"]
    return pool / 2**30 if pool > 0 else None
