"""Useful model FLOPs (real rows, real frames) of the window's requests over
the device's busy time at the float32 peak, %."""

from benchmark.harness import layers


def read(ctx, outcome):
    return layers.busy_mfu(outcome)
