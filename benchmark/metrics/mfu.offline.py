"""Model FLOPs of the captions completed over the window at the float32
peak, %."""

from benchmark.harness import layers


def read(ctx, outcome):
    return layers.window_mfu(outcome)
