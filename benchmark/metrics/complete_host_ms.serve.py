"""Mean self time of the caption service's completion of a batch: its
``service.complete`` span less its ``service.sync`` (the wait for the
device and the tokens' copy), so the text and the futures, ms."""

from benchmark.harness import spans


def read(ctx, outcome):
    return spans.self_ms(outcome.summary, "service.complete", "service.sync")
