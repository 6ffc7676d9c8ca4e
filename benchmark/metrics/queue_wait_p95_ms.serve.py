"""Nearest-rank 95th percentile of the window's request queue waits: each
request's ``service.queue`` span, from its submit to the batch that took
it (program spans on the trace's clock), ms."""

from benchmark.harness import spans


def read(ctx, outcome):
    return spans.p95_ms(outcome.summary, "service.queue")
