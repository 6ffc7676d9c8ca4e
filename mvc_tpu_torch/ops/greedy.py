"""Whole single-decoder greedy decode: the wrapper of ``csrc/greedy.cu`` and
its plain PyTorch version.

Port of ``mvc_tpu/ops/pallas_decode.py:greedy_decode_pallas``, the direct
mode of the single-stream ``AVCaptioning``.  Per step the decoder embeds its
own previous argmax, attends over the frames (masked additive attention;
over ``P = feats @ wi_ctx`` when ``_decode_common._use_factored`` holds),
runs the LSTM/GRU gates and projects onto the vocabulary; the running
argmax, lowest index on ties, is the token and the next step's input.
Tokens are ``[B, max_caption_len]`` int32 with column 0 = 0, then L-1 steps
on a fixed schedule (no early exit).  The arithmetic is the TPU kernel's
(``_embed_prev``, ``_attn_wsum``: energies -1e30 where masked, the maximum
replaced by 0 for an all-masked row, denominator >= 1e-30), with ``x``,
``h`` and the keys/P slab rounded to the weight dtype where it rounds them.

Outside the kernel, with ``torch.matmul`` as the JAX wrapper leaves it to
XLA: the attention keys ``feats @ U`` and, for a factored decoder, the slab
``P = feats @ wi_ctx``, both rounded to the weight dtype.
``greedy_decode`` launches the kernel for CUDA tensors and takes
``greedy_decode_reference`` only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from mvc_tpu_torch.config import SOS_ID
from mvc_tpu_torch.ops import _decode_common as _dc

_GreedyArgs = _dc.greedy_args_type(1)


def _one(decoder_params):
    """The one decoder tree as the shared helpers' list of one."""
    if not isinstance(decoder_params, dict):
        raise ValueError("the greedy decode takes exactly one decoder tree (a dict); "
                         f"got {type(decoder_params).__name__}")
    return [decoder_params]


def greedy_decode_reference(
    decoder_params: dict,
    feats: torch.Tensor,
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_type: str = "LSTM",
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic, rounding
    points and tie-break, step by step with whole-batch tensor ops."""
    return _dc.greedy_reference(_one(decoder_params), [feats], feat_mask, max_caption_len,
                                weight_dtype, (rnn_type,), sos_id, n_decoders=1)


def _library():
    return _dc.library("greedy", _GreedyArgs)


def _launch(args, weight_dtype, device) -> None:
    """One kernel launch on the current stream of ``device``; raises if the
    launch is refused.  The tensors behind ``args`` must outlive the call's
    enqueue (PyTorch's allocator orders their reuse on the same stream)."""
    _dc.launch("greedy", _library(), args, weight_dtype, device)
    _dc.count_launch(greedy_decode)


def prepare_kernel_call(decoder_params, feats, feat_mask=None, max_caption_len=30,
                        weight_dtype=torch.float32, rnn_type="LSTM", sos_id: int = SOS_ID):
    """Checks and the work outside the kernel for CUDA tensors.  Returns
    (args, tokens, keepalive): ``_launch(args, ...)`` fills ``tokens``;
    ``keepalive`` holds the operand tensors ``args`` points into."""
    return _dc.greedy_kernel_call(_GreedyArgs, _one(decoder_params), [feats], feat_mask,
                                  max_caption_len, weight_dtype, (rnn_type,), sos_id,
                                  n_decoders=1)


def greedy_decode(
    decoder_params: dict,
    feats: torch.Tensor,
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_type: str = "LSTM",
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Direct-mode greedy decode of one decoder -> int32 tokens
    [B, max_caption_len].

    ``decoder_params``: one decoder tree (JAX layout); ``feats``: [B, T, F];
    ``feat_mask``: [B, T] bool.  CUDA tensors launch the kernel on the
    current stream (asynchronously; ``greedy_decode.launches`` counts
    launches, under a lock); CPU tensors take the plain
    version.  Anything the kernel cannot take raises.  A clip of any length
    runs: above T=3230 at the single model's widths (F=2176, H=512, A=256,
    V=4000) the score rows live in a global workspace the call allocates."""
    if feats.device.type == "cpu":
        return greedy_decode_reference(decoder_params, feats, feat_mask, max_caption_len,
                                       weight_dtype, rnn_type, sos_id)
    args, tokens, _keepalive = prepare_kernel_call(decoder_params, feats, feat_mask,
                                                   max_caption_len, weight_dtype, rnn_type,
                                                   sos_id)
    _launch(args, weight_dtype, feats.device)
    return tokens


greedy_decode.launches = 0
