"""Temporal additive attention over the frame axis
(``mvc_tpu/models/attention.py:39-74``):

    energies_t = w . tanh(W h + U v_t + b)
    weights    = softmax_t(energies)           (masked positions -> -inf)
    context    = sum_t weights_t * v_t

The key projection ``U v_t`` is time-invariant and computed once per clip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mvc_tpu_torch.models.initializers import linear_params


def init_attention(gen, hidden_size: int, feature_size: int, bottleneck_size: int,
                   dtype=torch.float32, device="cpu"):
    return {
        "W": linear_params(gen, hidden_size, bottleneck_size, bias=False,
                           dtype=dtype, device=device)["w"],
        "U": linear_params(gen, feature_size, bottleneck_size, bias=False,
                           dtype=dtype, device=device)["w"],
        # The reference initializes the shared bias to ones.
        "b": torch.ones((bottleneck_size,), dtype=dtype, device=device),
        "w": linear_params(gen, bottleneck_size, 1, bias=False,
                           dtype=dtype, device=device)["w"][:, 0].contiguous(),
    }


def precompute_keys(params, feats: torch.Tensor) -> torch.Tensor:
    """[B, T, F] -> [B, T, A]; hoisted out of the decode loop."""
    return feats @ params["U"].to(feats.dtype)


def masked_softmax(energies: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax with exact zeros at masked positions.  Rows with no valid
    position yield all-zero weights instead of NaN — this keeps the
    service's batch-padding rows (mask all False) finite."""
    if mask is None:
        return torch.softmax(energies, dim=dim)
    e = energies.masked_fill(~mask, float("-inf"))
    m = e.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    unnorm = torch.where(mask, torch.exp(e - m), torch.zeros_like(e))
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / torch.clamp(denom, min=torch.finfo(energies.dtype).tiny)


def attention_weights(params, hidden: torch.Tensor, keys: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hidden [B, H], keys [B, T, A] -> weights [B, T]."""
    d = keys.dtype
    query = hidden.to(d) @ params["W"].to(d)                      # [B, A]
    energies = torch.tanh(query[:, None, :] + keys + params["b"].to(d)) @ params["w"].to(d)
    return masked_softmax(energies, mask, dim=1)


def attend(params, hidden: torch.Tensor, feats: torch.Tensor,
           keys: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B, H], feats [B, T, F], keys [B, T, A], mask [B, T] bool
    (True = attendable) -> (context [B, F], weights [B, T])."""
    if keys is None:
        keys = precompute_keys(params, feats)
    weights = attention_weights(params, hidden, keys, mask)
    context = torch.einsum("bt,btf->bf", weights, feats)
    return context, weights
