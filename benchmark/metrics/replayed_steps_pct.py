"""The device loop's replayed steps as a share of the window's steps
(``models.device_loop.STATS``)."""


def read(ctx):
    total = ctx.stats["replayed"] + ctx.stats["eager"]
    return 100.0 * ctx.stats["replayed"] / total if total else None
