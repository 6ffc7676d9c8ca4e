"""Multi-model routing over named :class:`CaptionService` instances
(``mvc_tpu/serving/router.py``).

Several captioners (the dual RNN model, its int8-weight variant, the
transformer, A/B variants) serve side by side on one card, each as a
service with its own batching worker, queue bound and stats; their
launches share the card's current stream.  The router is the one front-end
handle: the HTTP layer's ``"model"`` field routes through it.
"""

from __future__ import annotations

from typing import Dict, Optional

from mvc_tpu_torch.serving.service import CaptionService


class CaptionRouter:
    """Name -> CaptionService dispatch with a default route."""

    def __init__(self, services: Dict[str, CaptionService], default: Optional[str] = None):
        if not services:
            raise ValueError("router needs at least one service")
        self.services = dict(services)
        self.default = default if default is not None else next(iter(self.services))
        if self.default not in self.services:
            raise ValueError(f"default model {self.default!r} not in {sorted(self.services)}")

    def _resolve(self, model: Optional[str]) -> CaptionService:
        name = model or self.default
        svc = self.services.get(name)
        if svc is None:
            raise KeyError(f"unknown model {name!r}; available: {sorted(self.services)}")
        return svc

    # ------------------------------------------------------------ client API
    def submit(self, visual, audio=None, model: Optional[str] = None, **kw):
        return self._resolve(model).submit(visual, audio, **kw)

    def caption(self, visual, audio=None, model: Optional[str] = None,
                timeout: Optional[float] = None, **kw) -> str:
        return self.submit(visual, audio, model=model, **kw).result(timeout=timeout)

    def warmup(self, t_lengths=None) -> Dict[str, list]:
        return {name: svc.warmup(t_lengths) for name, svc in self.services.items()}

    def reset_stats(self) -> None:
        for svc in self.services.values():
            svc.reset_stats()

    def stats(self) -> Dict[str, object]:
        return {"default": self.default,
                "models": {name: svc.stats() for name, svc in self.services.items()}}

    def close(self) -> None:
        for svc in self.services.values():
            svc.close()

    def __enter__(self) -> "CaptionRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
