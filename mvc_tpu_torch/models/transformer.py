"""Multimodal transformer captioner (``mvc_tpu/models/transformer.py``).

Per-modality pre-norm encoders over the visual and audio features, one
caption decoder stack per modality (causal self-attention, cross-attention
to that modality's memory, ReLU FFN), and late fusion: the average of the
two streams' log-probs through one shared generator.  ``forward`` returns
``[L, B, V]`` log-probs with row 0 zeroed (the RNN captioners' loss
contract); ``predict_tokens`` decodes greedily or by beam search with
per-layer K/V caches, one step per position.  No reconstructors
(``reconstructor_type == "none"``).

The JAX package has no Pallas kernel here: attention, layer norm and the
FFN are plain XLA products, so the port computes them as ``torch.matmul``
/ ``einsum`` and ``softmax``, with the same masking formula
(``where(mask, logits, -1e9)``).  JAX promotes mixed float dtypes where
``torch.matmul`` refuses them: in a bf16 model the float32 positional
encoding lifts the residual stream to float32, and every product after it
takes float32 (``_mm``), as in the JAX model.

Parameters are a dict tree with the JAX layout: ``embedding.table``,
``visual_in`` / ``audio_in`` / ``generator`` linears (``w`` is [in, out]),
``ln_v`` / ``ln_a``, and the lists ``v_encoder``, ``a_encoder``,
``v_decoder``, ``a_decoder`` of per-layer trees.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from mvc_tpu_torch.config import SOS_ID, TransformerConfig
from mvc_tpu_torch.models import beam as beam_mod
from mvc_tpu_torch.models.captioning import captions_from_tokens
from mvc_tpu_torch.models.decoder import cast_params_for_decode
from mvc_tpu_torch.models.initializers import embedding_params, linear_params
from mvc_tpu_torch.utils.device import resolve_device


# ----------------------------------------------------------------- primitives
def _promote(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX computes it."""
    x, w = _promote(x, w)
    return x @ w


def _proj(p, x: torch.Tensor) -> torch.Tensor:
    return _mm(x, p["w"]) + p["b"]


def _layernorm_init(d: int, device):
    return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def _layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mha_init(gen, d_model: int, device):
    return {n: linear_params(gen, d_model, d_model, device=device) for n in ("q", "k", "v", "o")}


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, heads, L, D / heads]."""
    B, L, D = x.shape
    return x.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _attend(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention over [B, heads, L, hd] operands; ``mask``
    broadcastable to [B, heads, Lq, Lk], True = attendable."""
    q, k = _promote(q, k)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    weights, v = _promote(torch.softmax(logits, dim=-1), v)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _mha(p, q_in, kv_in, num_heads: int, mask=None) -> torch.Tensor:
    """q_in: [B, Lq, D], kv_in: [B, Lk, D]."""
    B, Lq, D = q_in.shape
    out = _attend(_heads(_proj(p["q"], q_in), num_heads), _heads(_proj(p["k"], kv_in), num_heads),
                  _heads(_proj(p["v"], kv_in), num_heads), mask)
    return _proj(p["o"], out.transpose(1, 2).reshape(B, Lq, D))


def _ffn_init(gen, d_model: int, d_ff: int, device):
    return {"in": linear_params(gen, d_model, d_ff, device=device),
            "out": linear_params(gen, d_ff, d_model, device=device)}


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    return _proj(p["out"], torch.relu(_proj(p["in"], x)))


def positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal encodings [max_len, d_model], computed in float64 and
    stored as float32."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    pe = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return pe.astype(np.float32)


# ----------------------------------------------------------------- stacks
def _encoder_layer_init(gen, cfg: TransformerConfig, device):
    return {"ln1": _layernorm_init(cfg.d_model, device), "attn": _mha_init(gen, cfg.d_model, device),
            "ln2": _layernorm_init(cfg.d_model, device),
            "ffn": _ffn_init(gen, cfg.d_model, cfg.d_ff, device)}


def _encoder_layer(p, x, cfg: TransformerConfig, mask):
    h = _layernorm(p["ln1"], x)
    x = x + _mha(p["attn"], h, h, cfg.num_heads, mask)
    return x + _ffn(p["ffn"], _layernorm(p["ln2"], x))


def _decoder_layer_init(gen, cfg: TransformerConfig, device):
    return {"ln1": _layernorm_init(cfg.d_model, device), "self": _mha_init(gen, cfg.d_model, device),
            "ln2": _layernorm_init(cfg.d_model, device), "cross": _mha_init(gen, cfg.d_model, device),
            "ln3": _layernorm_init(cfg.d_model, device),
            "ffn": _ffn_init(gen, cfg.d_model, cfg.d_ff, device)}


def _decoder_layer(p, x, memory, cfg: TransformerConfig, self_mask, cross_mask):
    h = _layernorm(p["ln1"], x)
    x = x + _mha(p["self"], h, h, cfg.num_heads, self_mask)
    x = x + _mha(p["cross"], _layernorm(p["ln2"], x), memory, cfg.num_heads, cross_mask)
    return x + _ffn(p["ffn"], _layernorm(p["ln3"], x))


# ------------------------------------------------- incremental (KV-cached)
def _mha_cached(p, q_in, k_cache, v_cache, num_heads: int, mask) -> torch.Tensor:
    """One query position against projected K/V. q_in: [B, 1, D];
    k_cache / v_cache: [B, Lk, D]."""
    B, _, D = q_in.shape
    out = _attend(_heads(_proj(p["q"], q_in), num_heads), _heads(k_cache, num_heads),
                  _heads(v_cache, num_heads), mask)
    return _proj(p["o"], out.transpose(1, 2).reshape(B, 1, D))


def _decoder_layer_step(p, x_t, t: int, cache: Dict[str, torch.Tensor], mem_kv,
                        cfg: TransformerConfig, cross_mask):
    """Position ``t`` through one decoder layer.  x_t: [B, 1, D]; ``cache``
    {"k", "v"} [B, Lh, D] gets this position's self K/V written in place (in
    the cache's dtype); ``mem_kv`` holds the layer's cross K/V."""
    h = _layernorm(p["ln1"], x_t)
    for name in ("k", "v"):
        cache[name][:, t] = _proj(p["self"][name], h)[:, 0].to(cache[name].dtype)
    Lh = cache["k"].shape[1]
    self_mask = (torch.arange(Lh, device=x_t.device) <= t)[None, None, None, :]
    x_t = x_t + _mha_cached(p["self"], h, cache["k"], cache["v"], cfg.num_heads, self_mask)
    x_t = x_t + _mha_cached(p["cross"], _layernorm(p["ln2"], x_t), mem_kv["k"], mem_kv["v"],
                            cfg.num_heads, cross_mask)
    return x_t + _ffn(p["ffn"], _layernorm(p["ln3"], x_t))


class TransformerCaptioning:
    """Audio+video transformer captioner with late log-prob fusion.  Like the
    RNN captioners, a stateless config holder whose ``device`` is where its
    entry points run: the card by default, ``device="cpu"`` for the CPU."""

    reconstructor_type = "none"

    def __init__(self, vocab_size: int, config: Optional[TransformerConfig] = None,
                 teacher_forcing_ratio: float = 1.0, dtype=torch.float32, device="cuda"):
        del teacher_forcing_ratio  # the transformer always teacher-forces in training
        self.cfg = (config or TransformerConfig()).replace(vocab_size=vocab_size)
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self._pe = torch.from_numpy(positional_encoding(self.cfg.max_len, self.cfg.d_model)).to(
            self.device)

    def init(self, gen: torch.Generator):
        """Random parameters from ``gen`` (a CPU generator), on the model's
        device: embeddings N(0, 1), linears U(±1/sqrt(in)), layer norms 1/0."""
        cfg, d = self.cfg, self.device
        params = {
            "embedding": embedding_params(gen, cfg.vocab_size, cfg.d_model, device=d),
            "visual_in": linear_params(gen, cfg.visual_dim, cfg.d_model, device=d),
            "audio_in": linear_params(gen, cfg.audio_dim, cfg.d_model, device=d),
            "generator": linear_params(gen, cfg.d_model, cfg.vocab_size, device=d),
            "ln_v": _layernorm_init(cfg.d_model, d), "ln_a": _layernorm_init(cfg.d_model, d),
            "v_encoder": [], "a_encoder": [], "v_decoder": [], "a_decoder": [],
        }
        for _ in range(cfg.num_layers):
            params["v_encoder"].append(_encoder_layer_init(gen, cfg, d))
            params["a_encoder"].append(_encoder_layer_init(gen, cfg, d))
            params["v_decoder"].append(_decoder_layer_init(gen, cfg, d))
            params["a_decoder"].append(_decoder_layer_init(gen, cfg, d))
        return params

    # ------------------------------------------------------------ encode
    def _encode(self, params, audio, visual, feat_mask):
        T = visual.shape[1]
        if T > self.cfg.max_len:
            raise ValueError(f"a clip of T={T} frames is longer than the positional "
                             f"encoding's {self.cfg.max_len}")
        v = _proj(params["visual_in"], visual.to(self.dtype)) + self._pe[:T]
        a = _proj(params["audio_in"], audio.to(self.dtype)) + self._pe[:T]
        enc_mask = feat_mask[:, None, None, :] if feat_mask is not None else None
        for vl, al in zip(params["v_encoder"], params["a_encoder"]):
            v = _encoder_layer(vl, v, self.cfg, enc_mask)
            a = _encoder_layer(al, a, self.cfg, enc_mask)
        return a, v, enc_mask

    def _fused_logp(self, params, xv, xa) -> torch.Tensor:
        """Late fusion: the average of the two streams' float32 log-probs."""
        g = params["generator"]
        v_logp = torch.log_softmax(_proj(g, _layernorm(params["ln_v"], xv)).float(), -1)
        a_logp = torch.log_softmax(_proj(g, _layernorm(params["ln_a"], xa)).float(), -1)
        return 0.5 * (v_logp + a_logp)

    def _decode_logits(self, params, tokens, a_mem, v_mem, cross_mask) -> torch.Tensor:
        """tokens: [B, L] -> fused log-probs [B, L, V] over the full prefix."""
        L = tokens.shape[1]
        x = params["embedding"]["table"][tokens.long()].to(self.dtype) + self._pe[:L]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, None]
        xv, xa = x, x
        for vl, al in zip(params["v_decoder"], params["a_decoder"]):
            xv = _decoder_layer(vl, xv, v_mem, self.cfg, causal, cross_mask)
            xa = _decoder_layer(al, xa, a_mem, self.cfg, causal, cross_mask)
        return self._fused_logp(params, xv, xa)

    # ------------------------------------------------------------ api
    def forward(self, params, audio, visual, captions, gen=None, teacher_forcing_ratio=None,
                feat_mask=None):
        """captions: [L, B] -> (outputs [L, B, V] log-probs with row 0
        zeroed, None, None)."""
        del gen, teacher_forcing_ratio
        a_mem, v_mem, cross_mask = self._encode(params, audio, visual, feat_mask)
        logp = self._decode_logits(params, captions.t()[:, :-1], a_mem, v_mem, cross_mask)
        out = logp.transpose(0, 1)                      # position t predicts token t+1
        zeros = torch.zeros((1,) + tuple(out.shape[1:]), dtype=out.dtype, device=out.device)
        return torch.cat([zeros, out], dim=0), None, None

    def _cross_kv(self, params, a_mem, v_mem):
        """Each decoder layer's cross-attention K/V of its memory, projected
        once per call."""
        def kv(layers, mem):
            return [{"k": _proj(lp["cross"]["k"], mem), "v": _proj(lp["cross"]["v"], mem)}
                    for lp in layers]
        return kv(params["a_decoder"], a_mem), kv(params["v_decoder"], v_mem)

    def _empty_caches(self, shape) -> List[Dict[str, torch.Tensor]]:
        return [{n: torch.zeros(shape, dtype=self.dtype, device=self._pe.device) for n in "kv"}
                for _ in range(self.cfg.num_layers)]

    def _step(self, params, prev, t: int, v_caches, a_caches, v_kv, a_kv, cross_mask):
        """Position ``t`` through both decoder stacks: fused log-probs [N, V]."""
        x_t = params["embedding"]["table"][prev].to(self.dtype)[:, None, :] + self._pe[t:t + 1]
        xv, xa = x_t, x_t
        for i in range(self.cfg.num_layers):
            xv = _decoder_layer_step(params["v_decoder"][i], xv, t, v_caches[i], v_kv[i],
                                     self.cfg, cross_mask)
            xa = _decoder_layer_step(params["a_decoder"][i], xa, t, a_caches[i], a_kv[i],
                                     self.cfg, cross_mask)
        return self._fused_logp(params, xv, xa)[:, 0]

    @torch.no_grad()
    def predict_tokens(self, params, audio, visual, max_caption_len: int = 30,
                       mode: str = "direct", beam_alpha: float = 0.0, beam_width: int = 5,
                       feat_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token ids.  Direct: [B, max_caption_len], column 0 = SOS, greedy
        with K/V caches.  Beam: [B, max_caption_len + 2], column 0 = SOS,
        ``models/beam.beam_search`` over cached steps."""
        if mode not in ("direct", "beam"):
            raise ValueError(f"mode must be 'direct' or 'beam', got {mode}")
        if visual.device != self.device or audio.device != self.device:
            raise ValueError(f"features must be on the model's device {self.device}")
        params = cast_params_for_decode(params, self.dtype)
        a_mem, v_mem, cross_mask = self._encode(params, audio, visual, feat_mask)
        a_kv, v_kv = self._cross_kv(params, a_mem, v_mem)
        B, D, L = visual.shape[0], self.cfg.d_model, int(max_caption_len)
        if mode == "direct":
            v_caches, a_caches = self._empty_caches((B, L, D)), self._empty_caches((B, L, D))
            tokens = torch.full((B, L), SOS_ID, dtype=torch.int32, device=self.device)
            prev = tokens[:, 0].long()
            for t in range(L - 1):
                logp = self._step(params, prev, t, v_caches, a_caches, v_kv, a_kv, cross_mask)
                prev = torch.argmax(logp, dim=-1)
                tokens[:, t + 1] = prev.to(torch.int32)
            return tokens

        # beam: caches [B, W, Lh, D] ride in the state, so the search's
        # regather permutes them with their beams; cross K/V and mask are
        # repeated W times along the batch (row b*W + w)
        W = int(beam_width)
        Lh = L + 1
        a_kv, v_kv = ([{n: x.repeat_interleave(W, dim=0) for n, x in lkv.items()} for lkv in kv]
                      for kv in (a_kv, v_kv))
        c_rep = cross_mask.repeat_interleave(W, dim=0) if cross_mask is not None else None

        def flat(caches):
            return [{n: x.reshape(B * W, Lh, D) for n, x in c.items()} for c in caches]

        def step_fn(prev, state):
            v_caches, a_caches, t = state
            logp = self._step(params, prev.reshape(B * W), t, flat(v_caches), flat(a_caches),
                              v_kv, a_kv, c_rep)
            return logp.reshape(B, W, -1), (v_caches, a_caches, t + 1)

        init = (self._empty_caches((B, W, Lh, D)), self._empty_caches((B, W, Lh, D)), 0)
        return beam_mod.beam_search(step_fn, init, B, self.vocab_size, max_caption_len=L,
                                    beam_alpha=beam_alpha, beam_width=W)

    def predict(self, params, vocab, audio, visual, **kw) -> List[str]:
        return captions_from_tokens(vocab, self.predict_tokens(params, audio, visual, **kw))

    def max_frames(self, params, batch: int, mode: str = "direct", beam_width: int = 5) -> int:
        """The longest clip the model takes: the positional encoding's length."""
        del params, batch, mode, beam_width
        return self.cfg.max_len

    def max_beam_width(self) -> int:
        """Any beam up to the vocabulary's size."""
        return self.vocab_size
