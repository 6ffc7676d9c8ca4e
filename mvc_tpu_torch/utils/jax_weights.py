"""Weights bridge between the JAX package's parameter trees and the port.

A JAX tree (numpy leaves, as ``mvc_tpu.training.checkpoint`` pickles it, or
``np.asarray`` of live JAX arrays) maps leaf for leaf onto a dict tree of
tensors with the same keys and the same layouts: ``wi`` is ``[E+F, G*H]``
with the embedding rows first, every linear ``w`` is ``[in, out]``.  Both
the ``init_decoder`` tree, the single model's tree (``decoder`` /
``reconstructor``) and the dual tree (``v_decoder`` / ``a_decoder`` /
``v_reconstructor`` / ``a_reconstructor``) go through unchanged; the
reconstructor leaves ride along although serving never runs them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def from_numpy_tree(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts of array leaves -> the same nesting of tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when it is given;
    ``None`` leaves (an absent reconstructor) stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy_tree(tree):
    """The port's tensor tree -> nested dicts of numpy arrays (float32 kept
    bit for bit)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()
