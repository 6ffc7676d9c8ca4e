"""Frame-bucket ladder shared by the data pipeline and the service
(``mvc_tpu/data/dataset.py:172-181``)."""

from __future__ import annotations

from typing import Sequence


def _bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value; above the ladder the bucket extends to the
    next multiple of the top rung, so no sample is ever truncated."""
    for b in buckets:
        if value <= b:
            return b
    top = buckets[-1]
    return ((value + top - 1) // top) * top
