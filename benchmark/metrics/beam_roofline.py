"""The beam decode's share of its roofline: each traced call's least time
at the published float32 and HBM peaks (every beam runs all its steps:
EOS is below every word) over the device time of every kernel it launched
(the wrapper's matmuls and ``beam.cu``'s ``beam_kernel``, which ends each
call), %."""

from benchmark.harness import layers


def read(ctx, outcome):
    return layers.decode_roofline(ctx, outcome, "beam_kernel")
