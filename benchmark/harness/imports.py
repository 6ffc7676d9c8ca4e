"""The check that nothing the benchmark runs has loaded JAX or the JAX
package: every loaded module's top-level name (the part before the first
dot) compared whole, since the port's name ``mvc_tpu_torch`` begins with
the JAX package's ``mvc_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mvc_tpu"})


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden(names: Iterable[str] = None, banned=FORBIDDEN) -> List[str]:
    """The banned top-level names among ``names`` (default: ``sys.modules``)."""
    return sorted(top_level(sys.modules if names is None else names) & set(banned))
