"""Image resize for the visual pipeline (``mvc_tpu/ops/resize.py``).

The JAX package resizes with ``jax.image.resize`` (linear, antialiased);
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``
computes the same triangle-filter resample.  The host decode path keeps
cv2's ``INTER_AREA`` (``extract/video_io.py``), as the reference does."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_frames(frames: torch.Tensor, height: int = 299, width: int = 299) -> torch.Tensor:
    """[N, H, W, C] -> [N, height, width, C] float32, linear + antialias."""
    x = frames.to(torch.float32).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear", antialias=True,
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()
