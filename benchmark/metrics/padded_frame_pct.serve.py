"""Share of the frames the service launched that hold no clip: bucket
padding and batch padding to ``max_batch`` (launched frames from the
harness's wrapper around ``predict_tokens``, real frames from the
requests), %."""


def read(ctx, outcome):
    return outcome.layer.get("padded_frame_pct")
