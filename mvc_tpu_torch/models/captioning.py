"""Captioners (``mvc_tpu/models/captioning.py``): ``AVCaptioning`` (one
decoder over the concatenated ``[audio | visual]`` features) and
``AVCaptioningDual`` (per-modality decoders whose log-probs are summed),
each with its reconstructors, the training forwards and direct- and
beam-mode ``predict_tokens``; the plain composition
``dual_greedy_tokens_fused``, the dual training decodes
(``dual_decode_fused`` / ``dual_decode_hiddens``) and
``captions_from_tokens``.

Like the JAX models they are stateless config holders; parameters live in
a plain dict tree with the JAX layout (``decoder`` / ``reconstructor`` for
the single model, ``v_decoder`` / ``a_decoder`` / ``v_reconstructor`` /
``a_reconstructor`` for the dual one).

The training forwards take ``shards`` (``parallel/collectives.Shards``):
a rank of a tp/sp mesh then holds its vocab slice of each decoder's
embedding and projection and its block of the frames, and its outputs are
its vocab slice of the log-probs and, for a local reconstructor, the
reconstruction of its own frames.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mvc_tpu_torch.config import (
    AUDIO_DECODER_CONFIG,
    EOS_ID,
    SINGLE_DECODER_CONFIG,
    SOS_ID,
    VISUAL_DECODER_CONFIG,
    DecoderConfig,
    ReconstructorConfig,
)
from mvc_tpu_torch.models import beam as beam_mod
from mvc_tpu_torch.models import decoder as dec
from mvc_tpu_torch.models import reconstructor as rec
from mvc_tpu_torch.models import rnn
from mvc_tpu_torch.ops import quant, sharded
from mvc_tpu_torch.ops.beam import beam_decode
from mvc_tpu_torch.ops.beam import max_width as beam_max_width
from mvc_tpu_torch.ops.dual_greedy import dual_greedy_decode
from mvc_tpu_torch.ops.greedy import greedy_decode
from mvc_tpu_torch.utils import tracing
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
    v_params, v_feats, v_keys, v_P = dec.decode_operands(v_params, visual, dtype)
    a_params, a_feats, a_keys, a_P = dec.decode_operands(a_params, audio, dtype)
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


def _shared_gen(teacher_forcing_ratio: float, gen: Optional[torch.Generator]):
    """The one generator both decoders draw their coins from, the visual
    decoder's first (seeded 0 when None)."""
    if gen is None and teacher_forcing_ratio > 0:
        gen = torch.Generator().manual_seed(0)
    return gen


def dual_decode_fused(v_params, a_params, v_cfg: DecoderConfig, a_cfg: DecoderConfig,
                      visual: torch.Tensor, audio: torch.Tensor,
                      captions: Optional[torch.Tensor], teacher_forcing_ratio: float,
                      gen: Optional[torch.Generator], feat_mask: Optional[torch.Tensor],
                      dtype=torch.float32, max_caption_len: int = 30, shards=None):
    """Both decoders' ``decoder.decode`` (``mvc_tpu/models/captioning.py:188``),
    each with its own teacher-forcing coins, feeding its own argmax when not
    forced; ratio >= 1 takes the hoisted path.  Returns (v_outputs,
    v_hiddens, a_outputs, a_hiddens), each [L, B, *], row 0 zero."""
    gen = _shared_gen(teacher_forcing_ratio, gen)
    v_o, v_h = dec.decode(v_params, v_cfg, visual, captions, max_caption_len,
                          teacher_forcing_ratio, gen, feat_mask, dtype, shards)
    a_o, a_h = dec.decode(a_params, a_cfg, audio, captions, max_caption_len,
                          teacher_forcing_ratio, gen, feat_mask, dtype, shards)
    return v_o, v_h, a_o, a_h


def dual_decode_hiddens(v_params, a_params, v_cfg: DecoderConfig, a_cfg: DecoderConfig,
                        visual: torch.Tensor, audio: torch.Tensor, captions: torch.Tensor,
                        teacher_forcing_ratio: float, gen: Optional[torch.Generator],
                        feat_mask: Optional[torch.Tensor], dtype=torch.float32, shards=None):
    """Hiddens-only dual training decode (``mvc_tpu/models/captioning.py:257``):
    the trajectories of ``dual_decode_fused`` without stacking either
    decoder's [L, B, V] log-probs.  Returns (v_hiddens, a_hiddens), each
    [L, B, H] f32, row 0 zero."""
    gen = _shared_gen(teacher_forcing_ratio, gen)
    return (dec.decode_hiddens(v_params, v_cfg, visual, captions, teacher_forcing_ratio, gen,
                               feat_mask, dtype, shards),
            dec.decode_hiddens(a_params, a_cfg, audio, captions, teacher_forcing_ratio, gen,
                               feat_mask, dtype, shards))


def captions_from_tokens(vocab, tokens) -> List[str]:
    """[B, L] token ids -> caption strings; drops position 0 and stops at EOS."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    tokens = np.asarray(tokens)
    return [vocab.decode_indexes(row[1:]) for row in tokens]


def _reconstruct(params, cfg: ReconstructorConfig, hiddens, outputs, captions, t_local: int,
                 dtype, shards) -> Optional[torch.Tensor]:
    """``reconstructor.reconstruct`` over the clip's whole frame count; with
    frames split over sp a local reconstruction runs its recurrence over
    every frame and keeps this rank's block (a global one has no frame
    axis)."""
    t = t_local if shards is None else shards.global_frames(t_local)
    recons = rec.reconstruct(params, cfg, hiddens, outputs, captions, feat_len=t, dtype=dtype)
    if recons is None or shards is None or cfg.type != "local":
        return recons
    return shards.own_frames(recons)


def _check_reconstructor_type(reconstructor_type: str) -> None:
    if reconstructor_type not in ("none", "global", "local"):
        raise ValueError(f"reconstructor_type must be none, global or local, "
                         f"got {reconstructor_type!r}")


class AVCaptioning:
    """Single-stream concat-fusion captioner: one decoder over the
    ``[audio | visual]`` features (F=2176 at the reference widths) and one
    reconstructor of the concatenated features, whose output is split back
    at the audio width, audio first."""

    # forward takes ``shards=``: trains on a tp/sp mesh (parallel/collectives.py)
    shardable = True
    # its log-probs are this rank's vocab slice under tp
    vocab_sharded_logits = True

    def __init__(self, vocab_size: int, teacher_forcing_ratio: float = 0.0,
                 reconstructor_type: str = "none",
                 decoder_config: Optional[DecoderConfig] = None,
                 reconstructor_config: Optional[ReconstructorConfig] = None,
                 dtype=torch.float32, device="cuda"):
        _check_reconstructor_type(reconstructor_type)
        self.vocab_size = vocab_size
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.reconstructor_type = reconstructor_type
        self.dtype = dtype
        self.device = resolve_device(device)
        self.decoder_config = (decoder_config or SINGLE_DECODER_CONFIG).replace(
            output_size=vocab_size)
        # overwritten as the JAX model does (mvc_tpu/models/captioning.py:424-428)
        self.reconstructor_config = (reconstructor_config or ReconstructorConfig()).replace(
            type=reconstructor_type, decoder_size=self.decoder_config.rnn_hidden_size,
            hidden_size=self.decoder_config.in_feature_size)

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen`` (a CPU generator), on the model's
        device, drawn in the order decoder, reconstructor."""
        d = self.device
        return {"decoder": dec.init_decoder(gen, self.decoder_config, device=d),
                "reconstructor": rec.init_reconstructor(gen, self.reconstructor_config,
                                                        device=d)}

    def _split(self, recons, a_dim: int):
        if recons is None:
            return None, None
        return recons[:, :, :a_dim], recons[:, :, a_dim:]

    def forward(self, params, audio: torch.Tensor, visual: torch.Tensor,
                captions: torch.Tensor, gen: Optional[torch.Generator] = None,
                teacher_forcing_ratio: Optional[float] = None,
                feat_mask: Optional[torch.Tensor] = None, shards=None):
        """(outputs [L, B, V] log-probs, audio_recons, visual_recons)
        (``mvc_tpu/models/captioning.py:444``): the decoder over
        ``[audio | visual]``, its teacher-forcing coins drawn from ``gen``,
        then the reconstruction split at the audio width."""
        tf = self.teacher_forcing_ratio if teacher_forcing_ratio is None else teacher_forcing_ratio
        features = torch.cat([audio, visual], dim=-1)
        outputs, hiddens = dec.decode(params["decoder"], self.decoder_config, features, captions,
                                      captions.shape[0], tf, gen, feat_mask,
                                      self.dtype, shards)
        recons = _reconstruct(params["reconstructor"], self.reconstructor_config, hiddens,
                              outputs, captions, features.shape[1], self.dtype, shards)
        return (outputs, *self._split(recons, audio.shape[2]))

    def forward_hiddens(self, params, audio: torch.Tensor, visual: torch.Tensor,
                        captions: torch.Tensor, gen: Optional[torch.Generator] = None,
                        teacher_forcing_ratio: Optional[float] = None,
                        feat_mask: Optional[torch.Tensor] = None, shards=None):
        """The fused-loss forward (``mvc_tpu/models/captioning.py:472``): the
        trajectory and reconstruction of ``forward`` without the [L, B, V]
        stack.  Returns ((hiddens,), (out,) vocab projection, audio_recons,
        visual_recons)."""
        tf = self.teacher_forcing_ratio if teacher_forcing_ratio is None else teacher_forcing_ratio
        features = torch.cat([audio, visual], dim=-1)
        hiddens = dec.decode_hiddens(params["decoder"], self.decoder_config, features, captions,
                                     tf, gen, feat_mask, self.dtype, shards)
        recons = _reconstruct(params["reconstructor"], self.reconstructor_config, hiddens,
                              None, captions, features.shape[1], self.dtype, shards)
        return ((hiddens,), (params["decoder"]["out"],), *self._split(recons, audio.shape[2]))

    @tracing.traced("model.predict_tokens")
    def predict_tokens(self, params, audio: torch.Tensor, visual: torch.Tensor,
                       max_caption_len: int = 30, mode: str = "direct",
                       beam_alpha: float = 0.0, beam_width: int = 5,
                       feat_mask: Optional[torch.Tensor] = None,
                       stop_at_all_eos: bool = False, mesh=None) -> torch.Tensor:
        """Token ids of the decoder over ``[audio | visual]``.  Direct mode:
        [B, max_caption_len], column 0 = 0, greedy.  Beam mode:
        [B, max_caption_len + 2], column 0 = SOS.

        CUDA tensors run the hand-written kernels (direct: ``greedy.cu`` on a
        fixed schedule, ``stop_at_all_eos`` is ignored and the caption text is
        the same; beam: ``beam.cu`` with one decoder); CPU tensors run
        ``decode_greedy_tokens`` or ``beam_search``.  ``stop_at_all_eos``
        applies to direct mode only.  An int8-quantized decoder
        (``ops/quant.py``) is dequantized once, in the model dtype, and then
        takes the same route.  With ``mesh`` the batch is split over its
        devices and each shard takes that route on its own
        (``ops/sharded.mesh_decode``)."""
        if mode not in ("direct", "beam"):
            raise ValueError(f"mode must be 'direct' or 'beam', got {mode}")
        if visual.device != self.device or audio.device != self.device:
            raise ValueError(f"features must be on the model's device {self.device}")

        def local(decoder, feats, mask):
            return self._predict_local(decoder, feats[0], max_caption_len, mode, beam_alpha,
                                       beam_width, mask, stop_at_all_eos)

        return sharded.mesh_decode(mesh, local, params["decoder"],
                                   [torch.cat([audio, visual], dim=-1)], feat_mask)

    def _predict_local(self, decoder, features, max_caption_len, mode, beam_alpha, beam_width,
                       feat_mask, stop_at_all_eos) -> torch.Tensor:
        cfg, dtype = self.decoder_config, self.dtype
        decoder = quant.dequantize_tree(decoder, dtype)
        if features.device.type == "cuda":
            decoder = dec.cast_params_for_decode(decoder, dtype)
            if mode == "beam":
                return beam_decode([decoder], [features], feat_mask, max_caption_len,
                                   beam_width, beam_alpha, weight_dtype=dtype,
                                   rnn_types=(cfg.rnn_type,))
            return greedy_decode(decoder, features, feat_mask, max_caption_len,
                                 weight_dtype=dtype, rnn_type=cfg.rnn_type)
        if mode == "direct":
            return dec.decode_greedy_tokens(decoder, cfg, features,
                                            max_caption_len=max_caption_len,
                                            feat_mask=feat_mask, dtype=dtype,
                                            stop_at_all_eos=stop_at_all_eos)
        dec_params, feats, keys, P = dec.decode_operands(decoder, features, dtype)

        def step_fn(prev, state):
            return dec.decoder_beam_step(dec_params, cfg, prev, state, feats, keys, feat_mask,
                                         dtype, P=P)

        init_state = _beam_init_state(cfg.rnn_type, feats.shape[0], beam_width,
                                      cfg.rnn_hidden_size, dtype, feats.device)
        return beam_mod.beam_search(step_fn, init_state, feats.shape[0], self.vocab_size,
                                    max_caption_len=max_caption_len, beam_alpha=beam_alpha,
                                    beam_width=beam_width)

    def predict(self, params, vocab, audio, visual, max_caption_len=30, mode="direct",
                beam_alpha=0.0, beam_width=5, feat_mask=None) -> List[str]:
        tokens = self.predict_tokens(params, audio, visual, max_caption_len, mode, beam_alpha,
                                     beam_width, feat_mask)
        return captions_from_tokens(vocab, tokens)

    def max_frames(self, params, batch: int, mode: str = "direct",
                   beam_width: int = 5) -> Optional[int]:
        """None: the kernels (``greedy.cu``, ``beam.cu``) take a clip of any
        length, as the CPU path does."""
        del params, batch, mode, beam_width
        return None

    def max_beam_width(self) -> int:
        """The widest beam the card's ``beam.cu`` takes."""
        return beam_max_width()


class AVCaptioningDual:
    """Dual-stream late-fusion captioner — the model the reference trains.
    Fusion is an elementwise sum of the two decoders' log-probs; each
    decoder has its own reconstructor (``reconstructor_type``)."""

    # forward takes ``shards=``: trains on a tp/sp mesh (parallel/collectives.py)
    shardable = True
    # its log-probs are this rank's vocab slice under tp
    vocab_sharded_logits = True

    def __init__(self, vocab_size: int, teacher_forcing_ratio: float = 0.0,
                 reconstructor_type: str = "none",
                 visual_decoder_config: Optional[DecoderConfig] = None,
                 audio_decoder_config: Optional[DecoderConfig] = None,
                 reconstructor_config: Optional[ReconstructorConfig] = None,
                 dtype=torch.float32, device="cuda"):
        _check_reconstructor_type(reconstructor_type)
        self.vocab_size = vocab_size
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.reconstructor_type = reconstructor_type
        self.dtype = dtype
        self.device = resolve_device(device)
        self.v_config = (visual_decoder_config or VISUAL_DECODER_CONFIG).replace(
            output_size=vocab_size)
        self.a_config = (audio_decoder_config or AUDIO_DECODER_CONFIG).replace(
            output_size=vocab_size)
        rbase = reconstructor_config or ReconstructorConfig()
        self.v_rec_config = rbase.replace(type=reconstructor_type,
                                          decoder_size=self.v_config.rnn_hidden_size,
                                          hidden_size=self.v_config.in_feature_size)
        self.a_rec_config = rbase.replace(type=reconstructor_type,
                                          decoder_size=self.a_config.rnn_hidden_size,
                                          hidden_size=self.a_config.in_feature_size)

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen`` (a CPU generator), on the model's
        device, drawn in the order v_decoder, a_decoder, v_reconstructor,
        a_reconstructor."""
        d = self.device
        return {
            "v_decoder": dec.init_decoder(gen, self.v_config, device=d),
            "a_decoder": dec.init_decoder(gen, self.a_config, device=d),
            "v_reconstructor": rec.init_reconstructor(gen, self.v_rec_config, device=d),
            "a_reconstructor": rec.init_reconstructor(gen, self.a_rec_config, device=d),
        }

    def _reconstruct(self, params, v_h, a_h, v_out, a_out, captions, audio, visual, shards):
        a_rec = _reconstruct(params["a_reconstructor"], self.a_rec_config, a_h, a_out, captions,
                             audio.shape[1], self.dtype, shards)
        v_rec = _reconstruct(params["v_reconstructor"], self.v_rec_config, v_h, v_out, captions,
                             visual.shape[1], self.dtype, shards)
        return a_rec, v_rec

    def forward(self, params, audio: torch.Tensor, visual: torch.Tensor,
                captions: torch.Tensor, gen: Optional[torch.Generator] = None,
                teacher_forcing_ratio: Optional[float] = None,
                feat_mask: Optional[torch.Tensor] = None, shards=None):
        """(outputs [L, B, V] summed log-probs, audio_recons, visual_recons)
        (``mvc_tpu/models/captioning.py:658``); each decoder draws its own
        teacher-forcing coins from ``gen``."""
        tf = self.teacher_forcing_ratio if teacher_forcing_ratio is None else teacher_forcing_ratio
        v_out, v_h, a_out, a_h = dual_decode_fused(
            params["v_decoder"], params["a_decoder"], self.v_config, self.a_config,
            visual, audio, captions, tf, gen, feat_mask, self.dtype, shards=shards)
        a_rec, v_rec = self._reconstruct(params, v_h, a_h, v_out, a_out, captions, audio, visual,
                                         shards)
        return a_out + v_out, a_rec, v_rec

    def forward_hiddens(self, params, audio: torch.Tensor, visual: torch.Tensor,
                        captions: torch.Tensor, gen: Optional[torch.Generator] = None,
                        teacher_forcing_ratio: Optional[float] = None,
                        feat_mask: Optional[torch.Tensor] = None, shards=None):
        """The fused-loss forward (``mvc_tpu/models/captioning.py:702``): the
        trajectories and reconstructions of ``forward`` without either
        [L, B, V] stack.  Returns ((v_hiddens, a_hiddens), (v_out, a_out)
        vocab projections, audio_recons, visual_recons)."""
        tf = self.teacher_forcing_ratio if teacher_forcing_ratio is None else teacher_forcing_ratio
        v_h, a_h = dual_decode_hiddens(
            params["v_decoder"], params["a_decoder"], self.v_config, self.a_config,
            visual, audio, captions, tf, gen, feat_mask, self.dtype, shards)
        a_rec, v_rec = self._reconstruct(params, v_h, a_h, None, None, captions, audio, visual,
                                         shards)
        outs = (params["v_decoder"]["out"], params["a_decoder"]["out"])
        return (v_h, a_h), outs, a_rec, v_rec

    @tracing.traced("model.predict_tokens")
    def predict_tokens(self, params, audio: torch.Tensor, visual: torch.Tensor,
                       max_caption_len: int = 30, mode: str = "direct",
                       beam_alpha: float = 0.0, beam_width: int = 5,
                       feat_mask: Optional[torch.Tensor] = None,
                       stop_at_all_eos: bool = False, mesh=None) -> torch.Tensor:
        """Token ids.  Direct mode: [B, max_caption_len], column 0 = 0; each
        decoder free-runs on its own argmax and the fused log-probs are
        argmaxed.  Beam mode: [B, max_caption_len + 2], column 0 = SOS; one
        beam search over the summed log-probs of both decoders.

        CUDA tensors run the hand-written kernels (direct: fixed schedule,
        ``stop_at_all_eos`` is ignored and the caption text is the same);
        CPU tensors run ``dual_greedy_tokens_fused`` or ``beam_search``.
        ``stop_at_all_eos`` applies to direct mode only.  Int8-quantized
        decoders (``ops/quant.py``) are dequantized once, in the model dtype,
        and then take the same route.  With ``mesh`` the batch is split
        over its devices and each shard takes that route on its own
        (``ops/sharded.mesh_decode``)."""
        if mode not in ("direct", "beam"):
            raise ValueError(f"mode must be 'direct' or 'beam', got {mode}")
        if visual.device != self.device or audio.device != self.device:
            raise ValueError(f"features must be on the model's device {self.device}")

        def local(decoders, feats, mask):
            return self._predict_local(decoders, feats[1], feats[0], max_caption_len, mode,
                                       beam_alpha, beam_width, mask, stop_at_all_eos)

        decoders = {k: params[k] for k in ("v_decoder", "a_decoder")}
        return sharded.mesh_decode(mesh, local, decoders, [visual, audio], feat_mask)

    def _predict_local(self, params, audio, visual, max_caption_len, mode, beam_alpha,
                       beam_width, feat_mask, stop_at_all_eos) -> torch.Tensor:
        rnn_types = (self.v_config.rnn_type, self.a_config.rnn_type)
        params = {k: quant.dequantize_tree(params[k], self.dtype)
                  for k in ("v_decoder", "a_decoder")}
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

    def predict(self, params, vocab, audio, visual, max_caption_len=30, mode="direct",
                beam_alpha=0.0, beam_width=5, feat_mask=None) -> List[str]:
        tokens = self.predict_tokens(params, audio, visual, max_caption_len, mode, beam_alpha,
                                     beam_width, feat_mask)
        return captions_from_tokens(vocab, tokens)

    def max_frames(self, params, batch: int, mode: str = "direct",
                   beam_width: int = 5) -> Optional[int]:
        """None: the kernels (``dual_greedy.cu``, ``beam.cu``) take a clip of
        any length, as the CPU path does."""
        del params, batch, mode, beam_width
        return None

    def max_beam_width(self) -> int:
        """The widest beam the card's ``beam.cu`` takes."""
        return beam_max_width()

    def _beam_tokens(self, params, audio, visual, max_caption_len, beam_alpha, beam_width,
                     feat_mask):
        """The joint beam over summed log-probs (``captioning.py:803-832``)."""
        B, dtype = visual.shape[0], self.dtype
        v_params, v_feats, v_keys, v_P = dec.decode_operands(params["v_decoder"], visual, dtype)
        a_params, a_feats, a_keys, a_P = dec.decode_operands(params["a_decoder"], audio, dtype)

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
