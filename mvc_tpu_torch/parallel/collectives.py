"""The collectives of tensor and sequence parallelism, written by hand.

In the JAX package GSPMD inserts them: ``mvc_tpu/parallel/mesh.py`` shards
the vocab axis of each RNN decoder's embedding table, ``out.w`` and
``out.b`` (of the transformer, only ``embedding.table``) over ``tp`` and
the frame axis T of the features and the frame mask over ``sp``, and XLA
reduces across the shards where the math needs it.  Here
each reduction is a call below, taken with a ``Shards`` that says where
this rank stands; with ``shards=None`` (or an axis of one) every function
is the single-process expression it replaces, unchanged.

The rule that makes the gradients right: every cross-rank reduction in the
forward pass is ``torch.distributed.nn.functional.all_reduce``, whose
backward sums the incoming gradients over the same ranks ("y_r = Σ_s x_s
for every r" has "dx_s = Σ_r dy_r"), and a max taken only to stabilise a
softmax is detached and reduced with ``ReduceOp.MAX``.  Each rank then
backpropagates its share of the global loss (``Shards.copies``) and the
trainer sums each gradient leaf over the ranks that hold the same slice of
it (``parallel/mesh.py`` ``sum_gradients``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shards:
    """One step's place of this rank on the ``tp`` and ``sp`` axes.

    ``tp_group``: the ranks that hold the other vocab slices (None when the
    vocab is whole here); this rank holds ids ``vocab_lo ..`` of it.
    ``sp_group``: the ranks that hold the other frames of this batch (None
    when its frames are whole here: sp is 1, or T is not divisible by it);
    this rank holds frame block ``sp_index`` of ``sp``.  ``copies``: the
    ranks (tp·sp) that compute the same value of a term whose inputs they
    all hold whole."""

    tp_group: object = None
    vocab_lo: int = 0
    sp_group: object = None
    sp: int = 1
    sp_index: int = 0
    tp: int = 1

    @property
    def copies(self) -> int:
        return self.tp * self.sp

    @property
    def frame_copies(self) -> int:
        """The ranks that compute the same value of a term over this rank's
        own frames: tp when the frames are split over sp, else all copies."""
        return self.tp if self.sp_group is not None else self.copies

    def global_frames(self, t_local: int) -> int:
        return t_local * self.sp if self.sp_group is not None else t_local

    def own_frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a tensor over the global frames."""
        if self.sp_group is None:
            return x
        t = x.shape[dim] // self.sp
        return x.narrow(dim, self.sp_index * t, t)


def _tp(shards: Optional[Shards]):
    return None if shards is None else shards.tp_group


def _sp(shards: Optional[Shards]):
    return None if shards is None else shards.sp_group


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` (``x`` itself without one); backward: the incoming
    gradients summed over it."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def _detached_max(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The detached max over ``dim`` and the ranks of ``group``, if any."""
    m = x.detach().amax(dim=dim, keepdim=True)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m


def embed(table: torch.Tensor, ids: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """``table[ids]`` over a vocab-sharded table: each rank looks up the ids
    in its slice (zeros for the others), then the rows are summed over tp,
    where exactly one rank contributes each.  Backward: the rows' gradient
    summed over tp reaches every rank, and each scatters it into the rows of
    its own slice only."""
    group = _tp(shards)
    if group is None:
        return table[ids]
    local = ids.long() - shards.vocab_lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return _sum(torch.where(inside[..., None], rows, torch.zeros_like(rows)), group)


def log_softmax(logits: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """``log_softmax`` over the last axis, sharded over tp: a detached max
    over the ranks, then the exponentials' sum over them.  Backward: the
    sum's gradient is summed over tp, so each rank's logits get
    ``g - softmax · Σ g`` over the whole vocab."""
    group = _tp(shards)
    if group is None:
        return torch.log_softmax(logits, dim=-1)
    m = _detached_max(logits, -1, group)
    s = _sum(torch.exp(logits - m).sum(dim=-1, keepdim=True), group)
    return logits - m - torch.log(s)


def vocab_sum(x: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """Σ over the last (vocab) axis, sharded over tp."""
    return _sum(x.sum(dim=-1), _tp(shards))


def pick(logp: torch.Tensor, gold: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """``logp[..., gold]`` with the vocab sharded over tp: the rank whose
    slice holds the gold id gives its value, the others 0, summed over tp.
    Backward: the gradient reaches the gold entry on its rank only."""
    group = _tp(shards)
    gold = gold.long()
    if group is None:
        return torch.gather(logp, -1, gold[..., None])[..., 0]
    local = gold - shards.vocab_lo
    inside = (local >= 0) & (local < logp.shape[-1])
    v = torch.gather(logp, -1, local.clamp(0, logp.shape[-1] - 1)[..., None])[..., 0]
    return _sum(torch.where(inside, v, torch.zeros_like(v)), group)


@torch.no_grad()
def argmax(logp: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """``torch.argmax(logp, -1)`` over a vocab sharded over tp, with torch's
    rule for ties (the first maximum): the largest value over the ranks,
    then the smallest global id among the ranks that hold it.  Not
    differentiable (the free-run decode feeds the id back)."""
    group = _tp(shards)
    if group is None:
        return torch.argmax(logp, dim=-1)
    idx = torch.argmax(logp, dim=-1)
    val = torch.gather(logp, -1, idx[..., None])[..., 0]
    best = val.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    cand = torch.where(val == best, idx + shards.vocab_lo,
                       torch.full_like(idx, torch.iinfo(idx.dtype).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand


def frame_softmax(energies: torch.Tensor, mask: Optional[torch.Tensor],
                  shards: Optional[Shards], dim: int = -1) -> torch.Tensor:
    """``models/attention.masked_softmax``: a softmax with exact zeros at
    masked positions, over a frame axis that may be sharded over sp.  The
    max and the denominator then span every sp rank, so a row whose local
    frames are all masked still gets its weights from the other shards, and
    only a row with no frame at all gets zeros (not NaN: the service's
    batch-padding rows stay finite).  Backward: the denominator's gradient
    is summed over sp."""
    group = _sp(shards)
    if mask is None:
        m = _detached_max(energies, dim, group)
        e = torch.exp(energies - m)
        return e / _sum(e.sum(dim=dim, keepdim=True), group)
    e = energies.masked_fill(~mask, float("-inf"))
    m = _detached_max(e, dim, group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    unnorm = torch.where(mask, torch.exp(e - m), torch.zeros_like(e))
    denom = _sum(unnorm.sum(dim=dim, keepdim=True), group)
    return unnorm / torch.clamp(denom, min=torch.finfo(energies.dtype).tiny)


def gather_frames(x: torch.Tensor, shards: Optional[Shards], dim: int = 1) -> torch.Tensor:
    """The whole frame axis (``dim``) from every sp rank's block: each rank
    writes its block into zeros and the sp group sums them, which NCCL and
    gloo both take for CUDA tensors (gloo gathers none).  Exact: every
    element has one nonzero term.  Backward: the gradient summed over sp,
    narrowed to this rank's block (``_sum``'s rule, through the pad)."""
    group = _sp(shards)
    if group is None:
        return x
    t = x.shape[dim]
    lo = shards.sp_index * t
    pad = [0, 0] * (x.ndim - 1 - dim) + [lo, (shards.sp - 1) * t - lo]
    return _sum(torch.nn.functional.pad(x, pad), group)


def frame_sum(x: torch.Tensor, shards: Optional[Shards]) -> torch.Tensor:
    """A partial sum over this rank's frames, completed over sp (the
    attention context); backward: the gradient summed over sp."""
    return _sum(x, _sp(shards))


def frames_split(shards: Optional[Shards]) -> bool:
    return _sp(shards) is not None
