"""Mean host time of a ``predict_tokens`` call of the served model: its
``model.predict_tokens`` span (checks, operands, the keys/P matmuls'
launches and the kernel's launch), ms."""

from benchmark.harness import spans


def read(ctx, outcome):
    return spans.mean_ms(outcome.summary, "model.predict_tokens")
