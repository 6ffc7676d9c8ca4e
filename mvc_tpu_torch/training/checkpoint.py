"""Checkpoints (``mvc_tpu/training/checkpoint.py``).

The format is the JAX package's: a pickle of ``{epoch, params, opt_state,
scheduler, history, ...}`` whose ``params`` hold numpy leaves in the JAX
tree layout, so either package reads the other's params
(``utils/jax_weights.from_numpy_tree`` / ``to_numpy_tree``).  The
optimizer state is each package's own: a JAX-side one unpickles here as an
opaque stand-in, and the trainer then reinitializes the optimizer.  Writes
are atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Any, Dict, Optional

import torch

from mvc_tpu_torch.utils.jax_weights import to_numpy_tree

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


def _to_host(value):
    """Tensor trees (dicts and lists) -> numpy trees; anything else as it is."""
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_host(v) for v in value]
    if isinstance(value, torch.Tensor):
        return to_numpy_tree(value)
    return value


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomic write of {epoch, params, opt_state, scheduler, history, ...};
    tensor leaves are written as numpy arrays."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    host = {k: _to_host(v) for k, v in payload.items()}
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


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


def restore_params_like(template, host_params):
    """Host arrays -> tensors with the dtype and device of ``template``'s
    leaves; raises ValueError when the two trees differ in structure or
    shape."""
    if template is None or host_params is None:
        if template is not None or host_params is not None:
            raise ValueError("checkpoint and model disagree on a reconstructor")
        return None
    if isinstance(template, dict):
        if not isinstance(host_params, dict) or set(template) != set(host_params):
            raise ValueError("checkpoint and model trees differ")
        return {k: restore_params_like(template[k], host_params[k]) for k in template}
    if isinstance(template, list):
        if not isinstance(host_params, list) or len(template) != len(host_params):
            raise ValueError("checkpoint and model trees differ")
        return [restore_params_like(t, h) for t, h in zip(template, host_params)]
    t = torch.as_tensor(host_params).to(device=template.device, dtype=template.dtype)
    if t.shape != template.shape:
        raise ValueError(f"leaf shape {tuple(t.shape)} != {tuple(template.shape)}")
    return t


class AsyncSaver:
    """Background checkpoint writer: ``submit`` snapshots the payloads to
    the host (training goes on updating the tensors in place) and hands the
    pickle and the write to a worker thread."""

    def __init__(self):
        self._thread = None
        self._error = None

    def wait(self) -> None:
        """Joins the write in flight; re-raises a failure from the worker."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, jobs) -> None:
        """jobs: list of (path, payload)."""
        self.wait()
        prepared = [(path, _to_host(payload)) for path, payload in jobs]

        def work():
            try:
                for path, payload in prepared:
                    save_checkpoint(path, payload)
            except BaseException as e:       # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
