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

Under data parallelism (``training/trainer.py`` with a mesh) each rank
holds only its rows, yet every batch mean must divide by the count over
all ranks, as the JAX package's single GSPMD program does: the ranks hold
different numbers of real rows and tokens, so averaging per-rank means
would weigh them wrongly.  ``counts`` (a ``GlobalCounts``) carries those
denominators; each rank's loss is then its share of the global loss, and
the ranks' gradients are summed.

On a tp/sp mesh ``counts.shards`` (``parallel/collectives.Shards``) says
where the rank stands: the log-softmax, the gold pick and the entropy's
vocab sum span a vocab sharded over tp, and the feature means a frame axis
sharded over sp.  The ranks of one dp index then compute the same value of
each term, which ``rank_shares`` divides among them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch

from mvc_tpu_torch.config import PAD_ID
from mvc_tpu_torch.parallel import collectives


@dataclass(frozen=True)
class GlobalCounts:
    """The batch means' denominators summed over the data-parallel ranks
    (``batch_counts`` all-reduced): non-PAD gold tokens, real rows, and real
    frames of real rows.  ``group`` is the process group of the ranks whose
    rows differ when there is more than one: the batch-axis entropy then
    spans them.  ``shards``: the rank's place on the tp and sp axes, or
    None."""

    tokens: torch.Tensor
    rows: torch.Tensor
    frames: torch.Tensor
    group: object = None
    shards: Optional[collectives.Shards] = None


def batch_counts(captions: torch.Tensor, sample_mask: Optional[torch.Tensor],
                 feat_mask: Optional[torch.Tensor], n_frames: int) -> torch.Tensor:
    """[3] float32: this batch's non-PAD gold tokens, real rows (all rows
    without ``sample_mask``) and the frames the local reconstruction
    averages over (``feat_mask`` and ``sample_mask`` as the loss takes them;
    ``n_frames`` per row without ``feat_mask``)."""
    tokens = (captions[1:] != PAD_ID).sum()
    rows = (sample_mask.sum() if sample_mask is not None
            else torch.tensor(captions.shape[1], device=captions.device))
    if feat_mask is None:
        frames = rows * n_frames
    elif sample_mask is None:
        frames = feat_mask.sum()
    else:
        frames = (feat_mask & sample_mask[:, None]).sum()
    return torch.stack([tokens, rows, frames]).float()


def global_counts(captions: torch.Tensor, sample_mask: Optional[torch.Tensor],
                  feat_mask: Optional[torch.Tensor], n_frames: int, group, row_group,
                  shards: Optional[collectives.Shards] = None) -> GlobalCounts:
    """``batch_counts`` summed over the ranks of ``group`` (one all-reduce).
    With ``shards`` the ranks of one dp index hold the same rows and count
    them ``copies`` times, and the same frames ``frame_copies`` times (once
    each across sp when the frames are split), so each sum is divided by
    that.  ``row_group``: the ranks whose rows differ, None when they are
    one."""
    import torch.distributed as dist

    c = batch_counts(captions, sample_mask, feat_mask, n_frames)
    dist.all_reduce(c, group=group)
    if shards is not None:
        c = c / torch.tensor([shards.copies, shards.copies, shards.frame_copies],
                             dtype=c.dtype, device=c.device)
    return GlobalCounts(c[0], c[1], c[2], group=row_group, shards=shards)


def _shards(counts: Optional[GlobalCounts]) -> Optional[collectives.Shards]:
    return None if counts is None else counts.shards


def rank_shares(ce, ent, a_rec, v_rec, rec_type: str, counts: Optional[GlobalCounts]):
    """This rank's shares of the four loss terms: each term divided by the
    ranks that compute its same value (a local reconstruction over the
    rank's own frames by ``frame_copies``, every other term by ``copies``),
    so that the shares of all ranks add up to the global loss.  The terms
    as they are without ``shards``."""
    shards = _shards(counts)
    if shards is None:
        return ce, ent, a_rec, v_rec
    n, n_rec = shards.copies, (shards.frame_copies if rec_type == "local" else shards.copies)
    return ce / n, ent / n, a_rec / n_rec, v_rec / n_rec


def _den(local: torch.Tensor, total: Optional[torch.Tensor]) -> torch.Tensor:
    """A batch mean's denominator: this batch's count, or the count over the
    ranks when there is one."""
    return torch.clamp(local if total is None else total, min=1.0)


def nll_loss(outputs: torch.Tensor, captions: torch.Tensor,
             counts: Optional[GlobalCounts] = None) -> torch.Tensor:
    """Mean NLL of the gold tokens over non-PAD positions [1:]; outputs
    [L, B, V] log-probs, captions [L, B]."""
    logp = outputs[1:]
    gold = captions[1:].long()
    picked = collectives.pick(logp, gold, _shards(counts))
    mask = (gold != PAD_ID).to(logp.dtype)
    return -(picked * mask).sum() / _den(mask.sum(), counts and counts.tokens)


def _row_mean(per_row: torch.Tensor, sample_mask: Optional[torch.Tensor],
              counts: Optional[GlobalCounts] = None) -> torch.Tensor:
    if counts is not None:
        if sample_mask is not None:
            per_row = per_row * sample_mask.to(per_row.dtype)
        return per_row.sum() / _den(None, counts.rows)
    if sample_mask is None:
        return per_row.mean()
    sm = sample_mask.to(per_row.dtype)
    return (per_row * sm).sum() / torch.clamp(sm.sum(), min=1.0)


def _batch_axis_log_softmax(x: torch.Tensor, group) -> torch.Tensor:
    """``log_softmax`` over the batch axis (dim 1) of the rows of every rank:
    a cross-rank max, then a differentiable cross-rank sum of the
    exponentials (its backward sums the ranks' gradients)."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    m = x.detach().amax(dim=1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = all_reduce(torch.exp(x - m).sum(dim=1, keepdim=True), op=dist.ReduceOp.SUM, group=group)
    return x - m - torch.log(s)


def entropy_loss(outputs_tail: torch.Tensor, ignore_mask: torch.Tensor,
                 compat_batch_axis: bool = False,
                 sample_mask: Optional[torch.Tensor] = None,
                 counts: Optional[GlobalCounts] = None) -> torch.Tensor:
    """-sum_words mean_batch sum_vocab p*log p over [L-1, B, V] log-probs;
    ``ignore_mask`` [L-1, B] is True on PAD."""
    shards = _shards(counts)
    if compat_batch_axis and counts is not None and counts.group is not None:
        logp = _batch_axis_log_softmax(outputs_tail, counts.group)
    elif compat_batch_axis:
        logp = torch.log_softmax(outputs_tail, dim=1)
    else:
        logp = collectives.log_softmax(outputs_tail, shards)
    b = collectives.vocab_sum(torch.exp(logp) * logp, shards)
    b = torch.where(ignore_mask, torch.zeros_like(b), b)
    return -1.0 * _row_mean(b.sum(dim=0), sample_mask, counts)


def _masked_time_mean(x: torch.Tensor, feat_mask: Optional[torch.Tensor],
                      shards: Optional[collectives.Shards] = None) -> torch.Tensor:
    """[B, T, F] -> [B, F] mean over the real frames (all frames without a
    mask).  With frames split over sp the sums and each row's frame count
    span the sp ranks before the count's ``clamp``."""
    if feat_mask is None and not collectives.frames_split(shards):
        return x.mean(dim=1)
    m = (torch.ones_like(x[:, :, :1]) if feat_mask is None
         else feat_mask.to(x.dtype)[:, :, None])
    s = collectives.frame_sum(torch.cat([(x * m).sum(dim=1), m.sum(dim=1)], dim=1), shards)
    return s[:, :-1] / torch.clamp(s[:, -1:], min=1.0)


def global_reconstruction_loss(features: torch.Tensor, recons: torch.Tensor,
                               keep_mask: torch.Tensor,
                               feat_mask: Optional[torch.Tensor] = None,
                               sample_mask: Optional[torch.Tensor] = None,
                               counts: Optional[GlobalCounts] = None) -> torch.Tensor:
    """features [B, T, F], recons [B, L, F], keep_mask [L, B] bool."""
    x = _masked_time_mean(features, feat_mask, _shards(counts))      # [B, F]
    m = keep_mask.t().to(recons.dtype)[:, :, None]                   # [B, L, 1]
    caption_len = keep_mask.sum(dim=0).to(recons.dtype)[:, None]
    x_recon = (recons * m).sum(dim=1) / torch.clamp(caption_len, min=1.0)
    sq = (x - x_recon) ** 2
    if counts is not None:
        if sample_mask is not None:
            sq = sq * sample_mask.to(sq.dtype)[:, None]
        return sq.sum() / _den(None, counts.rows * sq.shape[1])
    if sample_mask is None:
        return sq.mean()
    sm = sample_mask.to(sq.dtype)[:, None]
    return (sq * sm).sum() / torch.clamp(sm.sum() * sq.shape[1], min=1.0)


def local_reconstruction_loss(features: torch.Tensor, recons: torch.Tensor,
                              feat_mask: Optional[torch.Tensor] = None,
                              sample_mask: Optional[torch.Tensor] = None,
                              counts: Optional[GlobalCounts] = None) -> torch.Tensor:
    """Plain MSE; the masked forms average over real frames and real rows."""
    if counts is not None and feat_mask is None and sample_mask is None:
        sq = (features - recons) ** 2
        return sq.sum() / _den(None, counts.frames * features.shape[2])
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
    return sq.sum() / _den(m.sum() * features.shape[2],
                           counts and counts.frames * features.shape[2])


def _single_reconstruction_loss(captions, features, recons, rec_type: str, feat_mask=None,
                                sample_mask=None, counts=None) -> torch.Tensor:
    if recons is None or rec_type not in ("global", "local"):
        return torch.zeros((), device=captions.device)
    if rec_type == "global":
        return global_reconstruction_loss(features, recons, keep_mask=(captions != PAD_ID),
                                          feat_mask=feat_mask, sample_mask=sample_mask,
                                          counts=counts)
    return local_reconstruction_loss(features, recons, feat_mask=feat_mask,
                                     sample_mask=sample_mask, counts=counts)


def total_reconstruction_loss(outputs, captions, features=None, features_recons=None,
                              reg_lambda: float = 0.0, recon_lambda: float = 0.0,
                              reconstruction_type: str = "global", feat_mask=None,
                              compat_batch_axis_entropy: bool = False, sample_mask=None,
                              counts=None):
    """Single-feature loss.  Returns (loss, ce, entropy, recon)."""
    ce = nll_loss(outputs, captions, counts)
    ent = entropy_loss(outputs[1:], captions[1:] == PAD_ID, compat_batch_axis_entropy,
                       sample_mask=sample_mask, counts=counts)
    rec = _single_reconstruction_loss(captions, features, features_recons,
                                      reconstruction_type, feat_mask, sample_mask, counts)
    ce, ent, rec, _ = rank_shares(ce, ent, rec, rec, reconstruction_type, counts)
    return ce + reg_lambda * ent + recon_lambda * rec, ce, ent, rec


def modality_wise_reconstruction_loss(outputs, captions, audio_features=None,
                                      audio_features_recons=None, visual_features=None,
                                      visual_features_recons=None, reg_lambda: float = 0.0,
                                      audio_recon_lambda: float = 0.0,
                                      visual_recon_lambda: float = 0.0, rec_type: str = "none",
                                      feat_mask=None, compat_batch_axis_entropy: bool = False,
                                      sample_mask=None, counts=None):
    """Dual-modality loss.  Returns (loss, ce, entropy, audio_recon,
    visual_recon).  ``counts``: the denominators over the data-parallel
    ranks (``GlobalCounts``), None in one process; with ``counts.shards``
    each is this rank's share (``rank_shares``)."""
    ce = nll_loss(outputs, captions, counts)
    ent = entropy_loss(outputs[1:], captions[1:] == PAD_ID, compat_batch_axis_entropy,
                       sample_mask=sample_mask, counts=counts)
    a_rec = _single_reconstruction_loss(captions, audio_features, audio_features_recons,
                                        rec_type, feat_mask, sample_mask, counts)
    v_rec = _single_reconstruction_loss(captions, visual_features, visual_features_recons,
                                        rec_type, feat_mask, sample_mask, counts)
    ce, ent, a_rec, v_rec = rank_shares(ce, ent, a_rec, v_rec, rec_type, counts)
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
