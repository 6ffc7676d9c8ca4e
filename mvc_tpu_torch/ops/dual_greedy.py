"""Whole dual-decoder greedy decode: the wrapper of ``csrc/dual_greedy.cu``
and its plain PyTorch version.

Port of ``mvc_tpu/ops/pallas_dual_greedy.py:dual_greedy_decode_pallas``.
Each decoder free-runs on its OWN per-step argmax while the reported token
argmaxes the fused logits ``l_v + l_a`` (argmax of the summed log-probs:
the per-row log-sum-exp shift is constant).  Ties go to the lowest index.
Tokens are ``[B, max_caption_len]`` int32 with column 0 = 0, then L-1
steps on a fixed schedule (no early exit).

Outside the kernel, with ``torch.matmul`` as the JAX wrapper leaves it to
XLA: the attention keys ``feats @ U`` and, for a factored decoder, the slab
``P = feats @ wi_ctx`` (``_decode_common._use_factored``), both rounded to the weight
dtype.  ``dual_greedy_decode`` launches the kernel for CUDA tensors and
takes ``dual_greedy_decode_reference`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mvc_tpu_torch.config import SOS_ID
from mvc_tpu_torch.ops import _decode_common as _dc


def _check(decoder_params, feats_list, feat_mask, max_caption_len, weight_dtype, rnn_types):
    if int(max_caption_len) < 2:
        raise ValueError("max_caption_len must be >= 2")
    return _dc._check(decoder_params, feats_list, feat_mask, weight_dtype, rnn_types, (2,))


def dual_greedy_decode_reference(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic, rounding
    points and tie-break, step by step with whole-batch tensor ops."""
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len,
                     weight_dtype, rnn_types)
    device = feats_list[0].device
    wd = weight_dtype
    prep = _dc._prepare(decoder_params, feats_list, wd, rnn_types)
    mask = _dc._mask_f32(feat_mask, B, T, device) > 0
    hs = [torch.zeros((B, p["H"]), dtype=torch.float32, device=device) for p in prep]
    cs = [torch.zeros_like(h) for h in hs]
    prevs = [torch.full((B,), sos_id, dtype=torch.long, device=device) for _ in prep]
    tokens = torch.zeros((B, int(max_caption_len)), dtype=torch.int32, device=device)
    for step in range(int(max_caption_len) - 1):
        hs, cs = _dc.step_cells(prep, mask, hs, cs, prevs, wd)
        fused = torch.zeros((B, V), dtype=torch.float32, device=device)
        for d, p in enumerate(prep):
            logits = hs[d].to(wd).float() @ p["wout"].float() + p["b_out"]
            fused = fused + logits
            prevs[d] = torch.argmax(logits, dim=1)      # first maximum = lowest index
        tokens[:, step + 1] = torch.argmax(fused, dim=1).to(torch.int32)
    return tokens


class _DualGreedyArgs(ctypes.Structure):
    _fields_ = [("dec", _dc.DecoderArgs * 2), ("mask", ctypes.c_void_p),
                ("tokens", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("B", "T", "max_len", "V", "sos_id")]


def _library():
    return _dc.library("dual_greedy", _DualGreedyArgs)


def _launch(args: _DualGreedyArgs, weight_dtype, device) -> None:
    """One kernel launch on the current stream of ``device``; raises if the
    launch is refused.  The tensors behind ``args`` must outlive the call's
    enqueue (PyTorch's allocator orders their reuse on the same stream)."""
    _dc.launch("dual_greedy", _library(), args, weight_dtype, device)
    dual_greedy_decode.launches += 1


def prepare_kernel_call(decoder_params, feats_list, feat_mask=None, max_caption_len=30,
                        weight_dtype=torch.float32, rnn_types=("LSTM", "LSTM"),
                        sos_id: int = SOS_ID):
    """Checks and the work outside the kernel for CUDA tensors.  Returns
    (args, tokens, keepalive): ``_launch(args, ...)`` fills ``tokens``;
    ``keepalive`` holds the operand tensors ``args`` points into."""
    device = _dc._check_devices(decoder_params, feats_list, feat_mask)
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len,
                     weight_dtype, rnn_types)
    prep = _dc._prepare(decoder_params, feats_list, weight_dtype, rnn_types)
    mask = _dc._mask_f32(feat_mask, B, T, device)
    tokens = torch.empty((B, int(max_caption_len)), dtype=torch.int32, device=device)
    args = _DualGreedyArgs()
    for d, p in enumerate(prep):
        _dc.fill_decoder_args(args.dec[d], p)
    args.mask, args.tokens = mask.data_ptr(), tokens.data_ptr()
    args.B, args.T, args.max_len, args.V, args.sos_id = B, T, int(max_caption_len), V, sos_id
    return args, tokens, (prep, mask)


def dual_greedy_decode(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Dual direct-mode greedy decode -> int32 tokens [B, max_caption_len].

    ``decoder_params``: [visual, audio] decoder trees (JAX layout);
    ``feats_list``: [[B, T, Fv], [B, T, Fa]]; ``feat_mask``: [B, T] bool.
    CUDA tensors launch the kernel on the current stream (asynchronously;
    ``dual_greedy_decode.launches`` counts launches, from one thread at a
    time); CPU tensors take the plain version.  Anything the kernel cannot
    take raises, including a clip longer than the shared memory of a block
    holds: at the serving widths (H=512, A=256, V=4000) the kernel takes
    T <= 839 frames and raises ValueError above (the plain version has no
    limit)."""
    device = feats_list[0].device
    if device.type == "cpu":
        return dual_greedy_decode_reference(decoder_params, feats_list, feat_mask,
                                            max_caption_len, weight_dtype, rnn_types, sos_id)
    args, tokens, _keepalive = prepare_kernel_call(decoder_params, feats_list, feat_mask,
                                                   max_caption_len, weight_dtype,
                                                   rnn_types, sos_id)
    _launch(args, weight_dtype, device)
    return tokens


dual_greedy_decode.launches = 0
