"""PyTorch/CUDA port of ``mvc_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``mvc_tpu``.  Module paths and names follow the JAX
package so each port can be read against its reference.  The decode hot
paths run hand-written CUDA kernels (``ops/dual_greedy.py``,
``ops/greedy.py``, ``ops/beam.py``); every entry point runs on the card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mvc_tpu_torch import config  # noqa: F401,E402
