"""K1's share of its roofline: ``counts.k1.k1_bound`` of the configuration
over the device time of ``zslab_tendencies_kernel`` a step in whole
replayed calls."""

from benchmark.counts.k1 import k1_bound
from benchmark.trace import KERNEL_SYMBOLS


def read(ctx):
    ms = ctx.profiled.kernel_ms_per_step(KERNEL_SYMBOLS["zslab_tendencies.cu"])
    return None if ms is None else 100.0 * k1_bound(ctx.shape)[0] / ms
