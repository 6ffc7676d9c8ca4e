"""The dual direct decode's share of its roofline: each traced call's
least time at the published float32 and HBM peaks over the device time of
every kernel it launched (the wrapper's key matmuls and ``dual_greedy.cu``'s
``greedy_kernel``, which ends each call), %."""

from benchmark.harness import layers


def read(ctx, outcome):
    return layers.decode_roofline(ctx, outcome, "greedy_kernel")
