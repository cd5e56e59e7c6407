"""K6's share of its roofline: ``counts.k6.k6_bound`` of the configuration
over the device time of ``tendency_stage_kernel`` a step in whole replayed
calls."""

from benchmark.counts.k6 import k6_bound
from benchmark.trace import KERNEL_SYMBOLS


def read(ctx):
    ms = ctx.profiled.kernel_ms_per_step(KERNEL_SYMBOLS["tendencies.cu"])
    return None if ms is None else 100.0 * k6_bound(ctx.shape)[0] / ms
