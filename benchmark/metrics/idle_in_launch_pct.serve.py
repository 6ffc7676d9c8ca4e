"""The window's device-idle time that lies under the caption service's
``service.launch`` spans, over the window, %."""

from benchmark.harness import spans


def read(ctx, outcome):
    return spans.idle_under_pct(outcome.summary, "service.launch")
