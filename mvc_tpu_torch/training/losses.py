"""Training objective: NLL + entropy regularizer + MSE reconstruction
(``mvc_tpu/training/losses.py``).

- cross-entropy: NLL of the gold tokens over non-PAD positions [1:]
- entropy regularizer, PAD-masked, summed over words and averaged over the
  batch; ``compat_batch_axis=True`` takes the softmax over the batch axis
  as the reference does, the default over the vocab
- global reconstruction loss: MSE between the time-mean of the features
  and the caption-masked mean of the reconstructions, keep-mask
  ``captions != PAD`` (EOS included)
- local reconstruction loss: plain MSE

``feat_mask`` ([B, T] bool) drops padded frames from the feature means;
``sample_mask`` ([B] bool) drops batch-padding rows from every batch mean.
NLL needs no row mask: padded rows are all PAD.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from mvc_tpu_torch.config import PAD_ID


def nll_loss(outputs: torch.Tensor, captions: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the gold tokens over non-PAD positions [1:]; outputs
    [L, B, V] log-probs, captions [L, B]."""
    logp = outputs[1:]
    gold = captions[1:].long()
    picked = torch.gather(logp, 2, gold[:, :, None])[:, :, 0]
    mask = (gold != PAD_ID).to(logp.dtype)
    return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _row_mean(per_row: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_mask is None:
        return per_row.mean()
    sm = sample_mask.to(per_row.dtype)
    return (per_row * sm).sum() / torch.clamp(sm.sum(), min=1.0)


def entropy_loss(outputs_tail: torch.Tensor, ignore_mask: torch.Tensor,
                 compat_batch_axis: bool = False,
                 sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-sum_words mean_batch sum_vocab p*log p over [L-1, B, V] log-probs;
    ``ignore_mask`` [L-1, B] is True on PAD."""
    logp = torch.log_softmax(outputs_tail, dim=1 if compat_batch_axis else 2)
    b = (torch.exp(logp) * logp).sum(dim=2)
    b = torch.where(ignore_mask, torch.zeros_like(b), b)
    return -1.0 * _row_mean(b.sum(dim=0), sample_mask)


def _masked_time_mean(x: torch.Tensor, feat_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, F] -> [B, F] mean over the real frames (all frames without a mask)."""
    if feat_mask is None:
        return x.mean(dim=1)
    m = feat_mask.to(x.dtype)[:, :, None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def global_reconstruction_loss(features: torch.Tensor, recons: torch.Tensor,
                               keep_mask: torch.Tensor,
                               feat_mask: Optional[torch.Tensor] = None,
                               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features [B, T, F], recons [B, L, F], keep_mask [L, B] bool."""
    x = _masked_time_mean(features, feat_mask)                       # [B, F]
    m = keep_mask.t().to(recons.dtype)[:, :, None]                   # [B, L, 1]
    caption_len = keep_mask.sum(dim=0).to(recons.dtype)[:, None]
    x_recon = (recons * m).sum(dim=1) / torch.clamp(caption_len, min=1.0)
    sq = (x - x_recon) ** 2
    if sample_mask is None:
        return sq.mean()
    sm = sample_mask.to(sq.dtype)[:, None]
    return (sq * sm).sum() / torch.clamp(sm.sum() * sq.shape[1], min=1.0)


def local_reconstruction_loss(features: torch.Tensor, recons: torch.Tensor,
                              feat_mask: Optional[torch.Tensor] = None,
                              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain MSE; the masked forms average over real frames and real rows."""
    if feat_mask is None and sample_mask is None:
        return ((features - recons) ** 2).mean()
    if feat_mask is None:
        m = sample_mask.to(features.dtype)[:, None, None].expand(
            features.shape[0], features.shape[1], 1)
    else:
        m = feat_mask.to(features.dtype)[:, :, None]
        if sample_mask is not None:
            m = m * sample_mask.to(features.dtype)[:, None, None]
    sq = ((features - recons) ** 2) * m
    return sq.sum() / torch.clamp(m.sum() * features.shape[2], min=1.0)


def _single_reconstruction_loss(captions, features, recons, rec_type: str, feat_mask=None,
                                sample_mask=None) -> torch.Tensor:
    if recons is None or rec_type not in ("global", "local"):
        return torch.zeros((), device=captions.device)
    if rec_type == "global":
        return global_reconstruction_loss(features, recons, keep_mask=(captions != PAD_ID),
                                          feat_mask=feat_mask, sample_mask=sample_mask)
    return local_reconstruction_loss(features, recons, feat_mask=feat_mask,
                                     sample_mask=sample_mask)


def total_reconstruction_loss(outputs, captions, features=None, features_recons=None,
                              reg_lambda: float = 0.0, recon_lambda: float = 0.0,
                              reconstruction_type: str = "global", feat_mask=None,
                              compat_batch_axis_entropy: bool = False, sample_mask=None):
    """Single-feature loss.  Returns (loss, ce, entropy, recon)."""
    ce = nll_loss(outputs, captions)
    ent = entropy_loss(outputs[1:], captions[1:] == PAD_ID, compat_batch_axis_entropy,
                       sample_mask=sample_mask)
    rec = _single_reconstruction_loss(captions, features, features_recons,
                                      reconstruction_type, feat_mask, sample_mask)
    return ce + reg_lambda * ent + recon_lambda * rec, ce, ent, rec


def modality_wise_reconstruction_loss(outputs, captions, audio_features=None,
                                      audio_features_recons=None, visual_features=None,
                                      visual_features_recons=None, reg_lambda: float = 0.0,
                                      audio_recon_lambda: float = 0.0,
                                      visual_recon_lambda: float = 0.0, rec_type: str = "none",
                                      feat_mask=None, compat_batch_axis_entropy: bool = False,
                                      sample_mask=None):
    """Dual-modality loss.  Returns (loss, ce, entropy, audio_recon,
    visual_recon)."""
    ce = nll_loss(outputs, captions)
    ent = entropy_loss(outputs[1:], captions[1:] == PAD_ID, compat_batch_axis_entropy,
                       sample_mask=sample_mask)
    a_rec = _single_reconstruction_loss(captions, audio_features, audio_features_recons,
                                        rec_type, feat_mask, sample_mask)
    v_rec = _single_reconstruction_loss(captions, visual_features, visual_features_recons,
                                        rec_type, feat_mask, sample_mask)
    loss = ce + reg_lambda * ent + audio_recon_lambda * a_rec + visual_recon_lambda * v_rec
    return loss, ce, ent, a_rec, v_rec


def ModalityWiseReconstructionLossBuilder(reg_lambda: float, audio_recon_lambda: float,
                                          visual_recon_lambda: float, rec_type: str = "none",
                                          compat_batch_axis_entropy: bool = False):
    """``modality_wise_reconstruction_loss`` with its weights bound."""
    if rec_type not in ("none", "global", "local"):
        raise ValueError("Wrong mode specified, must be one of ['none', 'global', 'local']")
    return partial(modality_wise_reconstruction_loss, reg_lambda=reg_lambda,
                   audio_recon_lambda=audio_recon_lambda,
                   visual_recon_lambda=visual_recon_lambda, rec_type=rec_type,
                   compat_batch_axis_entropy=compat_batch_axis_entropy)
