"""Weights bridge between the JAX package's parameter trees and the port.

A JAX tree (numpy leaves, as ``mvc_tpu.training.checkpoint`` pickles it, or
``np.asarray`` of live JAX arrays) maps leaf for leaf onto a dict tree of
tensors with the same keys and the same layouts: ``wi`` is ``[E+F, G*H]``
with the embedding rows first, every linear ``w`` is ``[in, out]``.  Both
the ``init_decoder`` tree, the single model's tree (``decoder`` /
``reconstructor``) and the dual tree (``v_decoder`` / ``a_decoder`` /
``v_reconstructor`` / ``a_reconstructor``) go through unchanged; the
reconstructor leaves ride along although serving never runs them.

The extraction encoders' trees (``init_inception_v3``, ``init_resnet101``,
``init_vggish``) keep their keys and nesting too (lists of conv blocks
stay lists), with one change of layout: JAX convolves NHWC with HWIO
weights, the port NCHW with OIHW, so ``encoder_from_jax`` transposes
every 4-D ``w``.  fc weights stay ``[in, out]``; the VGGish PCA
``matrix`` / ``means`` pass through.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def from_numpy_tree(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts (and lists) of array or tensor leaves -> the same
    nesting of tensors on ``device``.  Floating leaves are cast to
    ``dtype`` when it is given; ``None`` leaves (an absent reconstructor)
    stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_numpy_tree(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
    else:
        t = torch.from_numpy(np.array(np.asarray(tree), copy=True))
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
    if isinstance(tree, list):
        return [to_numpy_tree(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _map_conv_weights(tree, axes, key=None):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_conv_weights(v, axes, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_conv_weights(v, axes) for v in tree]
    leaf = to_numpy_tree(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if key == "w" and leaf.ndim == 4:
        return np.ascontiguousarray(np.transpose(leaf, axes))
    return leaf


def encoder_from_jax(tree):
    """A JAX encoder tree (Inception-v3, ResNet-101 or VGGish; numpy or JAX
    leaves) -> the port's layout as numpy: every conv ``w`` HWIO -> OIHW.
    Pass the result to ``from_numpy_tree`` for tensors."""
    return _map_conv_weights(tree, (3, 2, 0, 1))


def encoder_to_jax(tree):
    """The inverse of ``encoder_from_jax`` (tensor or numpy leaves in, numpy
    out): every conv ``w`` OIHW -> HWIO."""
    return _map_conv_weights(tree, (2, 3, 1, 0))
