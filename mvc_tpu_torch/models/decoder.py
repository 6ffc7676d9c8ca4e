"""SoftAttention-RNN caption decoder, the decode-time subset of
``mvc_tpu/models/decoder.py``: init, the word step, the tokens-only greedy
decode and the beam-batched word step.

Params are a plain dict of tensors with the JAX package's layout:
``embedding.table [V, E]``, ``attention.{W [H, A], U [F, A], b [A], w [A]}``,
``rnn.{wi [E+F, G*H], wh [H, G*H], bi, bh}`` (embedding rows first in
``wi``) and ``out.{w [H, V], b [V]}``.  Log-probs are taken in float32
whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from mvc_tpu_torch.config import EOS_ID, SOS_ID, DecoderConfig
from mvc_tpu_torch.models import attention as attn
from mvc_tpu_torch.models import rnn
from mvc_tpu_torch.models.initializers import embedding_params, linear_params
from mvc_tpu_torch.ops._decode_common import _use_factored


def cast_params_for_decode(params, dtype):
    """The decoder tree with every floating leaf in ``dtype``, cast once
    before the decode loop.  Identity for float32."""
    if dtype == torch.float32:
        return params

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x.to(dtype) if x.is_floating_point() else x

    return cast(params)


def init_decoder(gen: torch.Generator, cfg: DecoderConfig, dtype=torch.float32, device="cpu"):
    return {
        "embedding": embedding_params(gen, cfg.output_size, cfg.embedding_size, dtype, device),
        "attention": attn.init_attention(gen, cfg.rnn_hidden_size, cfg.in_feature_size,
                                         cfg.attn_size, dtype, device),
        "rnn": rnn.init_rnn(gen, cfg.rnn_type, cfg.embedding_size + cfg.in_feature_size,
                            cfg.rnn_hidden_size, dtype, device),
        "out": linear_params(gen, cfg.rnn_hidden_size, cfg.output_size, dtype=dtype,
                             device=device),
    }


def factored_P(params, feats: torch.Tensor, dtype) -> Optional[torch.Tensor]:
    """P = feats @ wi_ctx [B, T, G*H] for the factored-context decode, or
    None when the direct path is cheaper (``ops._decode_common._use_factored``)."""
    wi = params["rnn"]["wi"]
    E = params["embedding"]["table"].shape[1]
    B, T, F = feats.shape
    if not _use_factored(B * T, F, wi.shape[1]):
        return None
    return feats.to(dtype) @ wi[E:].to(dtype)


def decode_operands(params, feats: torch.Tensor, dtype):
    """What every step of a decode reads, made once per decode: (the tree
    cast to ``dtype``, the features in ``dtype``, the attention keys, P or
    None)."""
    params = cast_params_for_decode(params, dtype)
    feats = feats.to(dtype)
    return (params, feats, attn.precompute_keys(params["attention"], feats),
            factored_P(params, feats, dtype))


def decoder_step(params, cfg: DecoderConfig, prev_tokens: torch.Tensor, state,
                 feats: torch.Tensor, keys: torch.Tensor,
                 feat_mask: Optional[torch.Tensor], dtype=torch.float32,
                 P: Optional[torch.Tensor] = None):
    """One word step.  Returns (log_probs [B, V] float32, new_state,
    attn_weights [B, T]).  With ``P`` the context rows of ``wi`` are replaced
    by the attention-weighted sum over P."""
    embedded = params["embedding"]["table"][prev_tokens].to(dtype)
    h = rnn.state_hidden(cfg.rnn_type, state)
    context, weights = attn.attend(params["attention"], h, feats, keys=keys, mask=feat_mask)
    if P is not None:
        E = embedded.shape[-1]
        wi = params["rnn"]["wi"]
        gi = (embedded @ wi[:E].to(dtype) + params["rnn"]["bi"].to(dtype)
              + torch.einsum("bt,bth->bh", weights, P))
        _, new_state = rnn.rnn_step_pre(params["rnn"], cfg.rnn_type, gi, state)
    else:
        x = torch.cat([embedded, context.to(dtype)], dim=-1)
        _, new_state = rnn.rnn_step(params["rnn"], cfg.rnn_type, x, state)
    h_new = rnn.state_hidden(cfg.rnn_type, new_state)
    logits = (h_new @ rnn.wmat(params["out"]["w"], dtype)
              + params["out"]["b"].to(dtype)).float()
    return torch.log_softmax(logits, dim=-1), new_state, weights


def decode_greedy_tokens(params, cfg: DecoderConfig, feats: torch.Tensor,
                         max_caption_len: int = 30, feat_mask: Optional[torch.Tensor] = None,
                         dtype=torch.float32, stop_at_all_eos: bool = False) -> torch.Tensor:
    """Tokens-only greedy decode (``mvc_tpu/models/decoder.py:326-390``): per
    step ``decoder_step`` and the argmax of its log-probs, fed back.  The
    CPU path of the single model's direct mode.  Returns [B, L] int32,
    column 0 = 0.

    ``stop_at_all_eos`` stops once every row has emitted EOS; later
    positions hold 0, which ``decode_indexes`` never reads (caption text
    identical)."""
    B = feats.shape[0]
    L = int(max_caption_len)
    params, feats, keys, P = decode_operands(params, feats, dtype)
    state = rnn.init_state(cfg.rnn_type, B, cfg.rnn_hidden_size, dtype, feats.device)
    prev = torch.full((B,), SOS_ID, dtype=torch.long, device=feats.device)
    tokens = torch.zeros((B, L), dtype=torch.int32, device=feats.device)
    seen = torch.zeros((B,), dtype=torch.bool, device=feats.device)
    for t in range(L - 1):
        if stop_at_all_eos and bool(seen.all()):
            break
        log_probs, state, _ = decoder_step(params, cfg, prev, state, feats, keys, feat_mask,
                                           dtype, P=P)
        prev = torch.argmax(log_probs, dim=-1)
        tokens[:, t + 1] = prev.to(torch.int32)
        seen |= prev == EOS_ID
    return tokens


def decoder_beam_step(params, cfg: DecoderConfig, prev_tokens: torch.Tensor, state,
                      feats: torch.Tensor, keys: torch.Tensor,
                      feat_mask: Optional[torch.Tensor], dtype=torch.float32,
                      P: Optional[torch.Tensor] = None):
    """Beam-batched word step (``mvc_tpu/models/decoder.py:393-431``): state
    leaves are [B, W, H] and the keys [B, T, A] are broadcast over the beam
    axis.  With ``P`` [B, T, G*H] the context rows of ``wi`` are replaced by
    the attention-weighted sum over P.

    Returns (log_probs [B, W, V] float32, new_state)."""
    ap = params["attention"]
    embedded = params["embedding"]["table"][prev_tokens].to(dtype)            # [B, W, E]
    h = rnn.state_hidden(cfg.rnn_type, state)                                 # [B, W, H]
    query = h @ ap["W"].to(dtype)                                             # [B, W, A]
    energies = torch.tanh(
        query[:, :, None, :] + keys[:, None, :, :] + ap["b"].to(dtype)
    ) @ ap["w"].to(dtype)                                                     # [B, W, T]
    mask = feat_mask[:, None, :].expand_as(energies) if feat_mask is not None else None
    weights = attn.masked_softmax(energies, mask, dim=-1)
    if P is not None:
        E = embedded.shape[-1]
        wi = params["rnn"]["wi"]
        gi = (embedded @ wi[:E].to(dtype) + params["rnn"]["bi"].to(dtype)
              + torch.einsum("bwt,bth->bwh", weights, P))
        _, new_state = rnn.rnn_step_pre(params["rnn"], cfg.rnn_type, gi, state)
    else:
        context = torch.einsum("bwt,btf->bwf", weights, feats)                # [B, W, F]
        x = torch.cat([embedded, context.to(dtype)], dim=-1)
        _, new_state = rnn.rnn_step(params["rnn"], cfg.rnn_type, x, state)
    h_new = rnn.state_hidden(cfg.rnn_type, new_state)
    logits = (h_new @ rnn.wmat(params["out"]["w"], dtype)
              + params["out"]["b"].to(dtype)).float()
    return torch.log_softmax(logits, dim=-1), new_state
