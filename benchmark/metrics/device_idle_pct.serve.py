"""100 less the union of the device's kernel, copy and memset intervals
over the traced window, %."""

from benchmark.harness import layers


def read(ctx, outcome):
    return layers.idle_pct(outcome)
