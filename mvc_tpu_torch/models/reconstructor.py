"""RecNet reconstructors: regenerate the input features from the decoder
hiddens (``mvc_tpu/models/reconstructor.py``).

Contracts (one layer, unidirectional, as every reference config):
  decoder_hiddens [L, B, H]   the decoder's h-states, row 0 zero
  caption_mask    [L, B] bool token != PAD and != EOS
  global output   [B, L, F]   with output[:, 0] == 0
  local  output   [B, T, F]
"""

from __future__ import annotations

from typing import Optional

import torch

from mvc_tpu_torch.config import EOS_ID, PAD_ID, ReconstructorConfig
from mvc_tpu_torch.models import attention as attn
from mvc_tpu_torch.models import rnn


def build_caption_mask(outputs: Optional[torch.Tensor],
                       captions: Optional[torch.Tensor]) -> torch.Tensor:
    """[L, B] bool, True on real (non-PAD, non-EOS) tokens; the argmax of the
    decoder outputs stands in when no gold captions are given.  The mask
    drops EOS while the global reconstruction loss keeps it (its mask is
    ``captions != PAD``), as in the reference (PARITY.md)."""
    if captions is None:
        captions = torch.argmax(outputs, dim=2)
    return (captions != PAD_ID) & (captions != EOS_ID)


def init_global_reconstructor(gen, cfg: ReconstructorConfig, dtype=torch.float32,
                              device="cpu"):
    return {"rnn": rnn.init_rnn(gen, cfg.rnn_type, cfg.decoder_size * 2, cfg.hidden_size,
                                dtype, device)}


def init_local_reconstructor(gen, cfg: ReconstructorConfig, dtype=torch.float32,
                             device="cpu"):
    return {
        "rnn": rnn.init_rnn(gen, cfg.rnn_type, cfg.decoder_size, cfg.hidden_size, dtype, device),
        "attention": attn.init_attention(gen, cfg.hidden_size, cfg.decoder_size,
                                         cfg.attn_size, dtype, device),
    }


def init_reconstructor(gen, cfg: ReconstructorConfig, dtype=torch.float32, device="cpu"):
    if cfg.type == "global":
        return init_global_reconstructor(gen, cfg, dtype, device)
    if cfg.type == "local":
        return init_local_reconstructor(gen, cfg, dtype, device)
    return None


def global_reconstruct(params, cfg: ReconstructorConfig, decoder_hiddens: torch.Tensor,
                       caption_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """RecNet-global: an RNN over [h_t ; masked mean of h] reproducing one
    global feature per step.  The input-side GEMM runs once over all steps
    and the recurrence is ``rnn_scan_pre``.  Returns [B, L, F]."""
    L, B, H = decoder_hiddens.shape
    hiddens = decoder_hiddens.to(dtype)
    mask = caption_mask.to(dtype)[:, :, None]                       # [L, B, 1]
    caption_lens = caption_mask.to(dtype).sum(dim=0)                # [B]
    # max(., 1): batch-padding rows have empty caption masks
    pooled = (hiddens * mask).sum(dim=0) / torch.clamp(caption_lens, min=1.0)[:, None]
    x_all = torch.cat([hiddens[1:], pooled[None].expand(L - 1, B, H)], dim=-1)
    gi_all = rnn.rnn_input_preact(params["rnn"], cfg.rnn_type, x_all)
    init_state = rnn.init_state(cfg.rnn_type, B, cfg.hidden_size, dtype, hiddens.device)
    recons = rnn.rnn_scan_pre(params["rnn"], cfg.rnn_type, gi_all, init_state).float()
    zeros = torch.zeros((1, B, cfg.hidden_size), dtype=torch.float32, device=recons.device)
    return torch.cat([zeros, recons], dim=0).transpose(0, 1)        # [B, L, F]


def local_reconstruct(params, cfg: ReconstructorConfig, decoder_hiddens: torch.Tensor,
                      caption_mask: torch.Tensor, feat_len: int,
                      dtype=torch.float32) -> torch.Tensor:
    """RecNet-local: per output frame, attend over the decoder hiddens
    (masked by caption positions) and step an RNN whose hidden size is the
    feature width.  Returns [B, T, F]."""
    L, B, H = decoder_hiddens.shape
    seq = decoder_hiddens.transpose(0, 1).to(dtype)                 # [B, L, H]
    attn_mask = caption_mask.t()                                    # [B, L]
    keys = attn.precompute_keys(params["attention"], seq)
    state = rnn.init_state(cfg.rnn_type, B, cfg.hidden_size, dtype, seq.device)
    recons = []
    for _ in range(int(feat_len)):
        h = rnn.state_hidden(cfg.rnn_type, state)
        context, _ = attn.attend(params["attention"], h, seq, keys=keys, mask=attn_mask)
        _, state = rnn.rnn_step(params["rnn"], cfg.rnn_type, context.to(dtype), state)
        recons.append(rnn.state_hidden(cfg.rnn_type, state).float())
    return torch.stack(recons, dim=1)                                # [B, T, F]


def reconstruct(params, cfg: ReconstructorConfig, decoder_hiddens: torch.Tensor,
                outputs: Optional[torch.Tensor], captions: Optional[torch.Tensor],
                feat_len: int, dtype=torch.float32) -> Optional[torch.Tensor]:
    """Dispatch on ``cfg.type``; None without a reconstructor."""
    if params is None or cfg.type not in ("global", "local"):
        return None
    mask = build_caption_mask(outputs, captions)
    if cfg.type == "global":
        return global_reconstruct(params, cfg, decoder_hiddens, mask, dtype)
    return local_reconstruct(params, cfg, decoder_hiddens, mask, feat_len, dtype)
