"""Mean host time of the caption service's launch of a batch: its
``service.launch`` span, from the batch's close to its put on the
completion queue (pad, H2D copy, ``predict_tokens``, back-pressure), ms."""

from benchmark.harness import spans


def read(ctx, outcome):
    return spans.mean_ms(outcome.summary, "service.launch")
