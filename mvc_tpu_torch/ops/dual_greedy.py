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

from typing import Optional, Sequence

import torch

from mvc_tpu_torch.config import SOS_ID
from mvc_tpu_torch.ops import _decode_common as _dc

_DualGreedyArgs = _dc.greedy_args_type(2)


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
    return _dc.greedy_reference(decoder_params, feats_list, feat_mask, max_caption_len,
                                weight_dtype, rnn_types, sos_id, n_decoders=2)


def _library():
    return _dc.library("dual_greedy", _DualGreedyArgs)


def _launch(args, weight_dtype, device) -> None:
    """One kernel launch on the current stream of ``device``; raises if the
    launch is refused.  The tensors behind ``args`` must outlive the call's
    enqueue (PyTorch's allocator orders their reuse on the same stream)."""
    _dc.launch("dual_greedy", _library(), args, weight_dtype, device)
    _dc.count_launch(dual_greedy_decode)


def prepare_kernel_call(decoder_params, feats_list, feat_mask=None, max_caption_len=30,
                        weight_dtype=torch.float32, rnn_types=("LSTM", "LSTM"),
                        sos_id: int = SOS_ID):
    """Checks and the work outside the kernel for CUDA tensors.  Returns
    (args, tokens, keepalive): ``_launch(args, ...)`` fills ``tokens``;
    ``keepalive`` holds the operand tensors ``args`` points into."""
    return _dc.greedy_kernel_call(_DualGreedyArgs, decoder_params, feats_list, feat_mask,
                                  max_caption_len, weight_dtype, rnn_types, sos_id,
                                  n_decoders=2)


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
    ``dual_greedy_decode.launches`` counts launches, under a lock); CPU
    tensors take the plain version.  Anything the kernel cannot take
    raises.  A clip of any length runs: above T=663 at the serving widths
    (H=512, A=256, V=4000) the score rows live in a global workspace the
    call allocates."""
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
