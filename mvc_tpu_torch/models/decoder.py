"""SoftAttention-RNN caption decoder (``mvc_tpu/models/decoder.py``): init,
the word step, the tokens-only greedy decode, the beam-batched word step
and the training decodes (``decode`` / ``decode_hiddens``, teacher-forced
with the hoisted GEMMs at ratio >= 1).

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
from mvc_tpu_torch.ops import quant
from mvc_tpu_torch.ops._decode_common import _use_factored


def cast_params_for_decode(params, dtype):
    """The tree (dicts and lists) with every floating leaf in ``dtype``, cast
    once before the decode loop; int8-quantized leaves (``ops/quant.py``)
    keep their int8 payload and float32 scales.  Identity for float32."""
    if dtype == torch.float32:
        return params

    def cast(x):
        if quant.is_quantized(x):
            return x
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
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


def _train_factored(B: int, T: int, F: int, H4: int, L: int) -> bool:
    """The training factoring rule (``mvc_tpu/models/decoder.py:153-164``):
    P's build GEMM and its backward must pay for themselves over only L-1
    scan steps, so P = feats @ wi_ctx is taken only when T < L-1 and the
    decode rule holds."""
    return T < L - 1 and _use_factored(B * T, F, H4)


def _fed_tokens(captions: torch.Tensor) -> torch.Tensor:
    """The gold tokens fed at steps 1..L-1: SOS first, then captions[1:-1]."""
    B = captions.shape[1]
    sos = torch.full((1, B), SOS_ID, dtype=captions.dtype, device=captions.device)
    return torch.cat([sos, captions[1:-1]], dim=0)


def _tf_hoisted_hiddens(params, cfg: DecoderConfig, feats, captions, feat_mask, dtype,
                        keys) -> torch.Tensor:
    """Teacher-forced hiddens [L-1, B, H] f32 with every hoistable GEMM
    hoisted (``mvc_tpu/models/decoder.py:125``): the embedded-side input
    GEMM runs once over all steps, the context rows of ``wi`` ride
    P = feats @ wi_ctx under the training factoring rule, and no vocab
    projection is made here."""
    L, B = captions.shape
    E = cfg.embedding_size
    wi = params["rnn"]["wi"]
    H4 = wi.shape[1]
    emb_all = params["embedding"]["table"][_fed_tokens(captions)].to(dtype)   # [L-1, B, E]
    gi_emb = emb_all @ wi[:E].to(dtype) + params["rnn"]["bi"].to(dtype)       # [L-1, B, H4]
    factored = _train_factored(B, feats.shape[1], feats.shape[2], H4, L)
    P = feats @ wi[E:].to(dtype) if factored else None                        # [B, T, H4]
    state = rnn.init_state(cfg.rnn_type, B, cfg.rnn_hidden_size, dtype, feats.device)
    hiddens = []
    for t in range(L - 1):
        h = rnn.state_hidden(cfg.rnn_type, state)
        if factored:
            weights = attn.attention_weights(params["attention"], h, keys, feat_mask)
            gi = gi_emb[t] + torch.einsum("bt,bth->bh", weights, P)
        else:
            context, _ = attn.attend(params["attention"], h, feats, keys=keys, mask=feat_mask)
            gi = gi_emb[t] + context.to(dtype) @ wi[E:].to(dtype)
        _, state = rnn.rnn_step_pre(params["rnn"], cfg.rnn_type, gi, state)
        hiddens.append(rnn.state_hidden(cfg.rnn_type, state).float())
    return torch.stack(hiddens)


def _pad0(x: torch.Tensor, width: int) -> torch.Tensor:
    """Prepend the contract's zero row 0: [L-1, B, w] -> [L, B, w] f32."""
    zeros = torch.zeros((1, x.shape[1], width), dtype=torch.float32, device=x.device)
    return torch.cat([zeros, x], dim=0)


def _project(params, hiddens, dtype) -> torch.Tensor:
    """Stacked hiddens -> float32 log-probs over the vocab."""
    logits = (hiddens.to(dtype) @ rnn.wmat(params["out"]["w"], dtype)
              + params["out"]["b"].to(dtype)).float()
    return torch.log_softmax(logits, dim=-1)


def _decode_tf_hoisted(params, cfg: DecoderConfig, feats, captions, feat_mask, dtype, keys):
    """Full teacher forcing: hoisted hiddens, then the vocab projection once
    over the stacked hiddens (``mvc_tpu/models/decoder.py:175``).  Returns
    (outputs [L, B, V], hiddens [L, B, H]), row 0 zero."""
    hiddens = _tf_hoisted_hiddens(params, cfg, feats, captions, feat_mask, dtype, keys)
    return (_pad0(_project(params, hiddens, dtype), cfg.output_size),
            _pad0(hiddens, cfg.rnn_hidden_size))


def teacher_forcing_coins(ratio: float, L: int, gen: Optional[torch.Generator]) -> torch.Tensor:
    """One teacher-forcing coin per step for the whole batch, drawn on the
    CPU from ``gen`` (a generator seeded 0 when None): [L] bool."""
    if ratio <= 0:
        return torch.zeros((L,), dtype=torch.bool)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    return torch.rand((L,), generator=gen) < ratio


def _free_run(params, cfg, feats, keys, gold, use_tf, feat_mask, dtype, keep_outputs):
    """The generic decode loop: per step ``decoder_step``, then the gold
    token where the step's coin says so, else the argmax, fed back.
    Returns (stacked log-probs or None, stacked hiddens f32), [L-1, B, *]."""
    B = feats.shape[0]
    state = rnn.init_state(cfg.rnn_type, B, cfg.rnn_hidden_size, dtype, feats.device)
    prev = torch.full((B,), SOS_ID, dtype=torch.long, device=feats.device)
    outs = [torch.zeros((0, B, cfg.output_size), device=feats.device)]
    hiddens = [torch.zeros((0, B, cfg.rnn_hidden_size), device=feats.device)]
    for t in range(1, gold.shape[0]):
        log_probs, state, _ = decoder_step(params, cfg, prev, state, feats, keys, feat_mask,
                                           dtype)
        prev = gold[t].long() if bool(use_tf[t]) else torch.argmax(log_probs, dim=-1)
        if keep_outputs:
            outs.append(log_probs[None])
        hiddens.append(rnn.state_hidden(cfg.rnn_type, state).float()[None])
    return (torch.cat(outs) if keep_outputs else None), torch.cat(hiddens)


def decode(params, cfg: DecoderConfig, feats: torch.Tensor,
           captions: Optional[torch.Tensor] = None, max_caption_len: int = 30,
           teacher_forcing_ratio: float = 1.0, gen: Optional[torch.Generator] = None,
           feat_mask: Optional[torch.Tensor] = None, dtype=torch.float32):
    """Full-sentence decode (``mvc_tpu/models/decoder.py:207``).  Ratio >= 1
    takes the hoisted path; otherwise one coin per step from ``gen`` picks
    gold or argmax feeding.  Returns (outputs [L, B, V] log-probs,
    hiddens [L, B, H]), row 0 zero."""
    B = feats.shape[0]
    L = int(captions.shape[0]) if captions is not None else int(max_caption_len)
    feats = feats.to(dtype)
    keys = attn.precompute_keys(params["attention"], feats)
    if captions is not None and teacher_forcing_ratio >= 1.0 and L > 1:
        return _decode_tf_hoisted(params, cfg, feats, captions, feat_mask, dtype, keys)
    use_tf = teacher_forcing_coins(teacher_forcing_ratio if captions is not None else 0.0, L, gen)
    gold = captions if captions is not None else torch.zeros(
        (L, B), dtype=torch.long, device=feats.device)
    outs, hiddens = _free_run(params, cfg, feats, keys, gold, use_tf, feat_mask, dtype, True)
    return _pad0(outs, cfg.output_size), _pad0(hiddens, cfg.rnn_hidden_size)


def decode_hiddens(params, cfg: DecoderConfig, feats: torch.Tensor, captions: torch.Tensor,
                   teacher_forcing_ratio: float = 1.0, gen: Optional[torch.Generator] = None,
                   feat_mask: Optional[torch.Tensor] = None, dtype=torch.float32):
    """Hiddens-only training decode (``mvc_tpu/models/decoder.py:265``): the
    trajectory of ``decode`` without stacking the [L, B, V] log-probs.
    Returns hiddens [L, B, H] f32, row 0 zero."""
    L = int(captions.shape[0])
    feats = feats.to(dtype)
    keys = attn.precompute_keys(params["attention"], feats)
    if teacher_forcing_ratio >= 1.0 and L > 1:
        hiddens = _tf_hoisted_hiddens(params, cfg, feats, captions, feat_mask, dtype, keys)
    else:
        use_tf = teacher_forcing_coins(teacher_forcing_ratio, L, gen)
        _, hiddens = _free_run(params, cfg, feats, keys, captions, use_tf, feat_mask, dtype,
                               False)
    return _pad0(hiddens, cfg.rnn_hidden_size)
