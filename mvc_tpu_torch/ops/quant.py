"""Weight-only int8 quantization for the decode (``mvc_tpu/ops/quant.py``).

The streamed matrices of each decoder, ``rnn.wi``, ``rnn.wh`` and the vocab
projection ``out.w``, are stored as int8 with one float32 scale per output
column (symmetric, ``round`` half to even, a zero column gets scale 1).
Opt-in, at predict time only: quantization perturbs the logits by ~1e-2
relative and can flip near-tied tokens.  Everything else of the tree (the
embedding table, the attention projections, the biases, the
reconstructors) stays in the model dtype.

The captioners' ``predict_tokens`` dequantize a quantized tree once per
call, in the model dtype, as ``wmat`` computes it (``q.to(dtype) *
s.to(dtype)``), and then decode as usual: on the card through the CUDA
kernels, on the CPU through the plain path.  The kernels read the
dequantized tiles; a kernel that streams the int8 tiles itself is later
kernel work.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

_QUANTIZED = (("rnn", "wi"), ("rnn", "wh"), ("out", "w"))


def quantize_weight(w) -> Dict[str, torch.Tensor]:
    """[in, out] float matrix -> {"q": int8 [in, out], "s": float32 [1, out]}."""
    w = torch.as_tensor(w).float()
    amax = w.abs().amax(dim=0, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def wmat(w, dtype) -> torch.Tensor:
    """A weight as a matrix in ``dtype``: dequantized int8 or a plain cast."""
    if is_quantized(w):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)


def quantize_decoder_params(dec_params: Dict) -> Dict:
    """A decoder tree (``models/decoder.init_decoder``) with ``rnn.wi``,
    ``rnn.wh`` and ``out.w`` quantized; every other leaf shared."""
    out = dict(dec_params)
    for sub, name in _QUANTIZED:
        out[sub] = dict(out[sub])
        out[sub][name] = quantize_weight(dec_params[sub][name])
    return out


def is_quantized_decoder(dec_params: Dict) -> bool:
    return is_quantized(dec_params.get("rnn", {}).get("wi"))


def quantize_model_params(params: Dict) -> Dict:
    """Quantize every decoder subtree of a captioner's tree (``decoder``;
    ``v_decoder`` / ``a_decoder``); reconstructors untouched."""
    out = dict(params)
    for name in ("decoder", "v_decoder", "a_decoder"):
        if out.get(name) is not None:
            out[name] = quantize_decoder_params(out[name])
    return out


def map_quantized(tree, fn: Callable):
    """The tree with ``fn`` applied to every quantized leaf (dicts and lists
    walked; other leaves as they are)."""
    if is_quantized(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_quantized(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_quantized(v, fn) for v in tree]
    return tree


def dequantize_tree(tree, dtype):
    """Every quantized leaf as its ``wmat`` in ``dtype``: the tree the decode
    kernels and the plain path read."""
    return map_quantized(tree, lambda w: wmat(w, dtype))
