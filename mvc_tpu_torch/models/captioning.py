"""Dual-stream captioner, the serving subset of ``mvc_tpu/models/captioning.py``:
``AVCaptioningDual`` (per-modality decoders whose log-probs are summed) with
direct- and beam-mode ``predict_tokens``, the plain composition
``dual_greedy_tokens_fused`` and ``captions_from_tokens``.

Like the JAX model it is a stateless config holder; parameters live in a
plain dict tree with the JAX layout (``v_decoder`` / ``a_decoder`` /
``v_reconstructor`` / ``a_reconstructor``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mvc_tpu_torch.config import (
    AUDIO_DECODER_CONFIG,
    EOS_ID,
    SOS_ID,
    VISUAL_DECODER_CONFIG,
    DecoderConfig,
)
from mvc_tpu_torch.models import attention as attn
from mvc_tpu_torch.models import beam as beam_mod
from mvc_tpu_torch.models import decoder as dec
from mvc_tpu_torch.models import rnn
from mvc_tpu_torch.ops.beam import beam_decode
from mvc_tpu_torch.ops.dual_greedy import dual_greedy_decode
from mvc_tpu_torch.utils.device import resolve_device


def _beam_init_state(rnn_type: str, B: int, W: int, H: int, dtype, device):
    h = torch.zeros((B, W, H), dtype=dtype, device=device)
    return (h, h) if rnn_type == "LSTM" else h


def dual_greedy_tokens_fused(v_params, a_params, v_cfg: DecoderConfig, a_cfg: DecoderConfig,
                             visual: torch.Tensor, audio: torch.Tensor, max_caption_len: int,
                             feat_mask: Optional[torch.Tensor], dtype=torch.float32,
                             stop_at_all_eos: bool = False) -> torch.Tensor:
    """Tokens-only dual direct decode (``captioning.py:323-392``): each decoder
    free-runs on its own argmax while the output stream argmaxes the fused
    log-probs per step.  Returns [B, L] int32 (column 0 = 0).

    ``stop_at_all_eos`` stops once every row's fused stream has emitted EOS;
    later positions hold 0, which ``decode_indexes`` never reads."""
    B = visual.shape[0]
    L = int(max_caption_len)
    device = visual.device
    v_params = dec.cast_params_for_decode(v_params, dtype)
    a_params = dec.cast_params_for_decode(a_params, dtype)
    v_feats, a_feats = visual.to(dtype), audio.to(dtype)
    v_keys = attn.precompute_keys(v_params["attention"], v_feats)
    a_keys = attn.precompute_keys(a_params["attention"], a_feats)
    v_P = dec.factored_P(v_params, v_feats, dtype)
    a_P = dec.factored_P(a_params, a_feats, dtype)
    v_prev = torch.full((B,), SOS_ID, dtype=torch.long, device=device)
    a_prev = v_prev.clone()
    v_state = rnn.init_state(v_cfg.rnn_type, B, v_cfg.rnn_hidden_size, dtype, device)
    a_state = rnn.init_state(a_cfg.rnn_type, B, a_cfg.rnn_hidden_size, dtype, device)
    tokens = torch.zeros((B, L), dtype=torch.int32, device=device)
    seen = torch.zeros((B,), dtype=torch.bool, device=device)
    for t in range(L - 1):
        if stop_at_all_eos and bool(seen.all()):
            break
        v_logp, v_state, _ = dec.decoder_step(v_params, v_cfg, v_prev, v_state, v_feats,
                                              v_keys, feat_mask, dtype, P=v_P)
        a_logp, a_state, _ = dec.decoder_step(a_params, a_cfg, a_prev, a_state, a_feats,
                                              a_keys, feat_mask, dtype, P=a_P)
        v_prev = torch.argmax(v_logp, dim=-1)
        a_prev = torch.argmax(a_logp, dim=-1)
        fused = torch.argmax(v_logp + a_logp, dim=-1)
        tokens[:, t + 1] = fused.to(torch.int32)
        seen |= fused == EOS_ID
    return tokens


def captions_from_tokens(vocab, tokens) -> List[str]:
    """[B, L] token ids -> caption strings; drops position 0 and stops at EOS."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    tokens = np.asarray(tokens)
    return [vocab.decode_indexes(row[1:]) for row in tokens]


class AVCaptioningDual:
    """Dual-stream late-fusion captioner — the model the reference trains.
    Fusion is an elementwise sum of the two decoders' log-probs."""

    def __init__(self, vocab_size: int, reconstructor_type: str = "none",
                 visual_decoder_config: Optional[DecoderConfig] = None,
                 audio_decoder_config: Optional[DecoderConfig] = None,
                 dtype=torch.float32, device="cuda"):
        self.vocab_size = vocab_size
        self.reconstructor_type = reconstructor_type
        self.dtype = dtype
        self.device = resolve_device(device)
        self.v_config = (visual_decoder_config or VISUAL_DECODER_CONFIG).replace(
            output_size=vocab_size)
        self.a_config = (audio_decoder_config or AUDIO_DECODER_CONFIG).replace(
            output_size=vocab_size)

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen`` (a CPU generator), on the model's
        device.  Reconstructors are not served and not ported yet."""
        if self.reconstructor_type != "none":
            raise NotImplementedError(
                "reconstructor init arrives with the training slice; serving reads "
                "checkpointed reconstructor leaves as they are")
        return {
            "v_decoder": dec.init_decoder(gen, self.v_config, device=self.device),
            "a_decoder": dec.init_decoder(gen, self.a_config, device=self.device),
            "v_reconstructor": None,
            "a_reconstructor": None,
        }

    def predict_tokens(self, params, audio: torch.Tensor, visual: torch.Tensor,
                       max_caption_len: int = 30, mode: str = "direct",
                       beam_alpha: float = 0.0, beam_width: int = 5,
                       feat_mask: Optional[torch.Tensor] = None,
                       stop_at_all_eos: bool = False) -> torch.Tensor:
        """Token ids.  Direct mode: [B, max_caption_len], column 0 = 0; each
        decoder free-runs on its own argmax and the fused log-probs are
        argmaxed.  Beam mode: [B, max_caption_len + 2], column 0 = SOS; one
        beam search over the summed log-probs of both decoders.

        CUDA tensors run the hand-written kernels (direct: fixed schedule,
        ``stop_at_all_eos`` is ignored and the caption text is the same);
        CPU tensors run ``dual_greedy_tokens_fused`` or ``beam_search``.
        ``stop_at_all_eos`` applies to direct mode only."""
        if mode not in ("direct", "beam"):
            raise ValueError(f"mode must be 'direct' or 'beam', got {mode}")
        if visual.device != self.device or audio.device != self.device:
            raise ValueError(f"features must be on the model's device {self.device}")
        rnn_types = (self.v_config.rnn_type, self.a_config.rnn_type)
        if visual.device.type == "cuda":
            decoders = [dec.cast_params_for_decode(params["v_decoder"], self.dtype),
                        dec.cast_params_for_decode(params["a_decoder"], self.dtype)]
            if mode == "beam":
                return beam_decode(decoders, [visual, audio], feat_mask, max_caption_len,
                                   beam_width, beam_alpha, weight_dtype=self.dtype,
                                   rnn_types=rnn_types)
            return dual_greedy_decode(decoders, [visual, audio], feat_mask, max_caption_len,
                                      weight_dtype=self.dtype, rnn_types=rnn_types)
        if mode == "direct":
            return dual_greedy_tokens_fused(
                params["v_decoder"], params["a_decoder"], self.v_config, self.a_config,
                visual, audio, max_caption_len=max_caption_len, feat_mask=feat_mask,
                dtype=self.dtype, stop_at_all_eos=stop_at_all_eos)
        return self._beam_tokens(params, audio, visual, max_caption_len, beam_alpha,
                                 beam_width, feat_mask)

    def _beam_tokens(self, params, audio, visual, max_caption_len, beam_alpha, beam_width,
                     feat_mask):
        """The joint beam over summed log-probs (``captioning.py:803-832``)."""
        B, dtype = visual.shape[0], self.dtype
        v_params = dec.cast_params_for_decode(params["v_decoder"], dtype)
        a_params = dec.cast_params_for_decode(params["a_decoder"], dtype)
        v_feats, a_feats = visual.to(dtype), audio.to(dtype)
        v_keys = attn.precompute_keys(v_params["attention"], v_feats)
        a_keys = attn.precompute_keys(a_params["attention"], a_feats)
        v_P = dec.factored_P(v_params, v_feats, dtype)
        a_P = dec.factored_P(a_params, a_feats, dtype)

        def step_fn(prev, state):
            v_state, a_state = state
            v_logp, v_new = dec.decoder_beam_step(v_params, self.v_config, prev, v_state,
                                                  v_feats, v_keys, feat_mask, dtype, P=v_P)
            a_logp, a_new = dec.decoder_beam_step(a_params, self.a_config, prev, a_state,
                                                  a_feats, a_keys, feat_mask, dtype, P=a_P)
            return v_logp + a_logp, (v_new, a_new)

        init_state = tuple(
            _beam_init_state(c.rnn_type, B, beam_width, c.rnn_hidden_size, dtype, visual.device)
            for c in (self.v_config, self.a_config))
        return beam_mod.beam_search(step_fn, init_state, B, self.vocab_size,
                                    max_caption_len=max_caption_len, beam_alpha=beam_alpha,
                                    beam_width=beam_width)
