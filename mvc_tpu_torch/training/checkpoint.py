"""Checkpoint loading (``mvc_tpu/training/checkpoint.py:115-126``).

The format is the JAX package's: a pickle of ``{epoch, params, opt_state,
...}`` with numpy leaves.  ``utils/jax_weights.from_numpy_tree`` turns the
``params`` tree into the port's tensors, for either model (``AVCaptioning``:
``{decoder, reconstructor}``; ``AVCaptioningDual``: ``{v_decoder,
a_decoder, v_reconstructor, a_reconstructor}``).  Saving belongs to the
training slice.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

# Modules whose classes may appear in a JAX-side checkpoint (optimizer state
# tuples): unpickled as opaque stand-ins, so loading never imports JAX.
_JAX_SIDE = ("jax", "jaxlib", "optax", "flax", "mvc_tpu")


class _Opaque:
    """Stand-in for a JAX-side object the port does not read."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _JAX_SIDE:
            return _Opaque
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """Returns the payload, or None when the file is absent or unreadable
    (the reference trains fresh in that case).  Unpickle only checkpoints
    this program wrote."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as f:
            return _Unpickler(f).load()
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError, ImportError) as e:
        print(f"Error loading from checkpoint: {path} ({e}).\nUsing default parameters...")
        return None
