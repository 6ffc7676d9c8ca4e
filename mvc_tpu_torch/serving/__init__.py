"""Online caption serving: continuous batching over the port's predict path,
one model per service, several behind a router."""

from mvc_tpu_torch.serving.http import make_http_server
from mvc_tpu_torch.serving.router import CaptionRouter
from mvc_tpu_torch.serving.service import (
    CaptionService,
    DeadlineExceeded,
    ServiceConfig,
    ServiceOverloaded,
)

__all__ = ["CaptionService", "CaptionRouter", "ServiceConfig", "ServiceOverloaded",
           "DeadlineExceeded", "make_http_server"]
