"""Whole beam search over the summed log-probs of 1 or 2 decoders: the
wrapper of ``csrc/beam.cu`` and its plain PyTorch version.

Port of ``mvc_tpu/ops/pallas_beam.py:beam_decode_pallas``, with the same
contract as ``models/beam.py:beam_search`` driving ``decoder_beam_step``:
tokens ``[B, max_caption_len + 2]`` int32, column 0 = SOS, then beam 0's
history over ``max_caption_len + 1`` steps with the all-finished early
exit.  The arithmetic is the TPU kernel's, not the XLA scan's: per row a
top-W of the fused logits ``l_0 + l_1`` (ties to the lowest token) whose
log-probs are ``value - sum_d lse_d``; per clip a top-W of the W*W
candidates by normalized score ``cand * 6^a / exp(a * log(5 + len))``,
ties to the lowest ``w*V + token``; a finished beam offers tokens 0..W-1
at its cumulative score.

The keys ``feats @ U`` and the factored slab ``P = feats @ wi_ctx`` stay
``torch.matmul`` outside the kernel (``ops/_decode_common.py``).
``beam_decode`` launches the kernel for CUDA tensors and takes
``beam_decode_reference`` only for CPU tensors.

The kernel runs on a tile of 15 rows (three clips at W=5) or 8 rows (one
clip at W=5); it picks the 15-row tile when that fits a block's shared
memory and holds more whole clips, which at the serving widths is every
frame bucket up to T=147 (dual model) or T=1618 (single model), and the
8-row tile for longer clips (``csrc/beam.cu:tile_rows``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mvc_tpu_torch.config import EOS_ID, SOS_ID
from mvc_tpu_torch.ops import _decode_common as _dc

NEG_INF = -1e9                   # dead-beam start score, as models/beam.py
TILES = (15, 8)                  # the kernel's row tiles; rows=0 lets it pick


def _check(decoder_params, feats_list, feat_mask, max_caption_len, beam_width,
           weight_dtype, rnn_types):
    if int(max_caption_len) < 0:
        raise ValueError("max_caption_len must be >= 0")
    B, T, V = _dc._check(decoder_params, feats_list, feat_mask, weight_dtype, rnn_types, (1, 2))
    if not 1 <= int(beam_width) <= V:
        raise ValueError(f"beam_width must be in [1, V={V}], got {beam_width}")
    return B, T, V


def _inv6a(alpha: float) -> float:
    """6^-alpha as the kernel receives it (a float32)."""
    return ctypes.c_float(6.0 ** -float(alpha)).value


def _top_lowest(x: torch.Tensor, k: int):
    """The k largest entries along the last axis, ties to the lowest index:
    (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_decode_reference(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    beam_width: int = 5,
    beam_alpha: float = 0.0,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
    sos_id: int = SOS_ID,
    eos_id: int = EOS_ID,
    return_steps: bool = False,
):
    """Plain PyTorch version of the kernel: the same arithmetic, rounding
    points and tie-breaks, step by step with whole-batch tensor ops.  With
    ``return_steps`` also returns int32 [B]: the steps the kernel runs for
    each clip (it stops after the step that begins with the clip's beams
    all finished)."""
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len, beam_width,
                     weight_dtype, rnn_types)
    device = feats_list[0].device
    wd, W, Lh = weight_dtype, int(beam_width), int(max_caption_len) + 1
    alpha = float(beam_alpha)
    prep = _dc._prepare(decoder_params, feats_list, wd, rnn_types)
    mask = _dc._mask_f32(feat_mask, B, T, device) > 0
    BW = B * W
    hs = [torch.zeros((BW, p["H"]), dtype=torch.float32, device=device) for p in prep]
    cs = [torch.zeros_like(h) for h in hs]
    prev = torch.full((BW,), sos_id, dtype=torch.long, device=device)
    beam = torch.arange(W, device=device)
    cum = torch.where(beam == 0, 0.0, NEG_INF).to(torch.float32).repeat(B)
    fin = torch.zeros((BW,), dtype=torch.bool, device=device)
    eos_len = torch.zeros((BW,), dtype=torch.int32, device=device)
    hist = torch.zeros((BW, Lh), dtype=torch.int32, device=device)
    steps = torch.full((B,), Lh, dtype=torch.int32, device=device)
    clip_base = torch.arange(B, device=device).repeat_interleave(W) * W
    for t in range(Lh):
        began = fin.view(B, W).all(dim=1)                  # the clip's beams all finished
        steps = torch.where(began & (steps == Lh), t + 1, steps).to(torch.int32)
        hs, cs = _dc.step_cells(prep, mask, hs, cs, [prev] * len(prep), wd, rows_per_clip=W)
        fused = torch.zeros((BW, V), dtype=torch.float32, device=device)
        lse = torch.zeros((BW,), dtype=torch.float32, device=device)
        for d, p in enumerate(prep):
            logits = hs[d].to(wd).float() @ p["wout"].float() + p["b_out"]
            lse = lse + torch.logsumexp(logits, dim=1)
            fused = fused + logits
        vals, toks = _top_lowest(fused, W)                  # [BW, W]
        cand = torch.where(fin[:, None], cum[:, None], cum[:, None] + (vals - lse[:, None]))
        tok = torch.where(fin[:, None], beam[None, :], toks)
        if alpha:
            lens = torch.where(fin, eos_len, t + 1).to(torch.float32)
            norm = torch.exp(alpha * torch.log(5.0 + lens)) * _inv6a(alpha)
            cand_n = cand / norm[:, None]
        else:
            cand_n = cand
        # per clip: W*W candidates (beam-major), ranked by normalized score,
        # ties to the lowest w*V + token
        cand_n, cand, tok = (x.reshape(B, W * W) for x in (cand_n, cand, tok))
        gidx = beam.repeat_interleave(W)[None, :] * V + tok
        sel = []
        taken = torch.zeros_like(cand_n, dtype=torch.bool)
        for _ in range(W):
            vals_left = torch.where(taken, torch.full_like(cand_n, -float("inf")), cand_n)
            best = vals_left.amax(dim=1, keepdim=True)
            tie = (vals_left == best) & ~taken
            j = torch.where(tie, gidx, torch.full_like(gidx, 2 ** 62)).argmin(dim=1)
            taken[torch.arange(B, device=device), j] = True
            sel.append(j)
        j = torch.stack(sel, dim=1)                          # [B, W] chosen flat candidates
        new_tok = tok.gather(1, j).reshape(BW)
        new_cum = cand.gather(1, j).reshape(BW)
        src = clip_base + (j // W).reshape(BW)               # the row each new beam extends
        hs = [h.index_select(0, src) for h in hs]
        cs = [c.index_select(0, src) if c is not None else None for c in cs]
        hist = hist.index_select(0, src)
        hist[:, t] = new_tok.to(torch.int32)
        src_fin, src_eos = fin[src], eos_len[src]
        is_eos = new_tok == eos_id
        fin = src_fin | is_eos
        eos_len = torch.where(src_fin, src_eos,
                              torch.where(is_eos, t + 1, 0).to(torch.int32)).to(torch.int32)
        cum, prev = new_cum, new_tok
        if bool(began.all()):
            break
    tokens = torch.cat([torch.full((B, 1), sos_id, dtype=torch.int32, device=device),
                        hist.view(B, W, Lh)[:, 0]], dim=1)
    return (tokens, steps) if return_steps else tokens


class _BeamArgs(ctypes.Structure):
    _fields_ = [("dec", _dc.DecoderArgs * 2), ("mask", ctypes.c_void_p),
                ("tokens", ctypes.c_void_p), ("steps", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("B", "T", "V", "W", "Lh", "n_dec", "sos_id", "eos_id")] + [
        ("alpha", ctypes.c_float), ("inv6a", ctypes.c_float)]


def _library():
    lib = _dc.library("beam", _BeamArgs, n_extra=1)
    if not getattr(lib, "_mvc_beam_bound", False):
        args_p = ctypes.POINTER(_BeamArgs)
        lib.beam_max_width.argtypes, lib.beam_max_width.restype = [], ctypes.c_int
        lib.beam_tile_rows.argtypes, lib.beam_tile_rows.restype = [args_p], ctypes.c_int
        lib.beam_max_active_clusters.argtypes = [args_p, ctypes.c_int, ctypes.c_int]
        lib.beam_max_active_clusters.restype = ctypes.c_int
        lib._mvc_beam_bound = True
    return lib


def _launch(args: _BeamArgs, weight_dtype, device, rows: int = 0) -> None:
    """One kernel launch on the current stream of ``device`` with a
    ``rows``-row tile (0: the kernel's choice by shape; else one of
    ``TILES``); raises ValueError if the tile does not fit a block's shared
    memory, RuntimeError if the launch is refused.  The tensors behind
    ``args`` must outlive the call's enqueue (PyTorch's allocator orders
    their reuse on the same stream)."""
    if rows not in (0,) + TILES:
        raise ValueError(f"the beam kernel's row tile is one of {TILES} (or 0), got {rows}")
    _dc.launch("beam", _library(), args, weight_dtype, device, int(rows))
    _dc.count_launch(beam_decode)


def prepare_kernel_call(decoder_params, feats_list, feat_mask=None, max_caption_len=30,
                        beam_width=5, beam_alpha=0.0, weight_dtype=torch.float32,
                        rnn_types=("LSTM", "LSTM"), sos_id: int = SOS_ID,
                        eos_id: int = EOS_ID):
    """Checks and the work outside the kernel for CUDA tensors.  Returns
    (args, tokens, steps, keepalive): ``_launch(args, ...)`` fills
    ``tokens`` and ``steps``; ``keepalive`` holds the operand tensors
    ``args`` points into."""
    device = _dc._check_devices(decoder_params, feats_list, feat_mask)
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len, beam_width,
                     weight_dtype, rnn_types)
    max_w = _library().beam_max_width()
    if int(beam_width) > max_w:
        raise ValueError(f"the beam kernel takes beam_width <= {max_w}, got {beam_width}")
    prep = _dc._prepare(decoder_params, feats_list, weight_dtype, rnn_types)
    mask = _dc._mask_f32(feat_mask, B, T, device)
    Lh = int(max_caption_len) + 1
    tokens = torch.empty((B, Lh + 1), dtype=torch.int32, device=device)
    steps = torch.empty((B,), dtype=torch.int32, device=device)
    args = _BeamArgs()
    for d, p in enumerate(prep):
        _dc.fill_decoder_args(args.dec[d], p)
    args.mask, args.tokens, args.steps = mask.data_ptr(), tokens.data_ptr(), steps.data_ptr()
    args.B, args.T, args.V, args.W, args.Lh = B, T, V, int(beam_width), Lh
    args.n_dec, args.sos_id, args.eos_id = len(prep), sos_id, eos_id
    args.alpha, args.inv6a = float(beam_alpha), _inv6a(beam_alpha)
    return args, tokens, steps, (prep, mask)


def max_width() -> int:
    """The widest beam the kernel takes (``beam_max_width``); builds the
    kernel on first use."""
    return int(_library().beam_max_width())


def max_frames(decoder_params, rnn_types=("LSTM", "LSTM"), batch: int = 64,
               beam_width: int = 5) -> int:
    """The largest T the kernel takes for these 1 or 2 decoders at
    ``batch`` clips of ``beam_width`` beams, on the row tile it picks, by its
    own shared-memory need; builds the kernel on first use."""
    args = _BeamArgs()
    args.V = decoder_params[0]["embedding"]["table"].shape[0]
    args.B, args.W, args.Lh, args.n_dec = batch, int(beam_width), 2, len(decoder_params)
    return _dc.max_frames(_library().beam_smem_bytes, args, decoder_params, rnn_types, batch, 0)


def beam_decode(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    beam_width: int = 5,
    beam_alpha: float = 0.0,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
) -> torch.Tensor:
    """Beam search over the summed log-probs of the decoders -> int32 tokens
    [B, max_caption_len + 2] beginning with SOS.

    ``decoder_params``: 1 or 2 decoder trees (JAX layout; the dual model
    passes [visual, audio]) with matching ``feats_list`` [[B, T, F_d]] and
    ``rnn_types`` (LSTM/GRU, mixed allowed; each decoder has its own
    F/H/A/E); ``feat_mask``: [B, T] bool.  CUDA tensors launch the kernel on
    the current stream (asynchronously; ``beam_decode.launches`` counts
    launches, under a lock); CPU tensors take the plain
    version.  Anything the kernel cannot take raises ValueError: a beam
    wider than 8 or a clip longer than a block's shared memory holds with
    the 8-row tile (T=1842 at the dual model's widths; the plain version
    has neither limit)."""
    device = feats_list[0].device
    if device.type == "cpu":
        return beam_decode_reference(decoder_params, feats_list, feat_mask, max_caption_len,
                                     beam_width, beam_alpha, weight_dtype, rnn_types)
    args, tokens, _steps, _keepalive = prepare_kernel_call(
        decoder_params, feats_list, feat_mask, max_caption_len, beam_width, beam_alpha,
        weight_dtype, rnn_types)
    _launch(args, weight_dtype, device)
    return tokens


beam_decode.launches = 0
