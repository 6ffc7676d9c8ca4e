"""Mean real rows a batch of the caption service launched over the window
(``CaptionService.stats()["mean_batch_occupancy"]``)."""


def read(ctx, outcome):
    return outcome.layer.get("batch_rows")
