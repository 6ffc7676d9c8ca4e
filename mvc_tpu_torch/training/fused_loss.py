"""Fused chunked-vocab CE + entropy: the loss straight from the decoder
hiddens, without the [L-1, B, V] log-prob stack
(``mvc_tpu/training/fused_loss.py``).

The two terms are those of ``losses.nll_loss`` / ``losses.entropy_loss``
(vocab-axis entropy) over the summed log-softmax of 1 or 2 streams:

  l_d    = h_d @ w_d + b_d                 (compute dtype, taken in f32)
  u      = sum_d l_d                       (softmax(sum_d log_softmax(l_d)) == softmax(u))
  ce_row = sum_d (l_d[gold] - lse(l_d))
  b_row  = sum_v p_v (u_v - lse(u)),       p = softmax(u)

The forward streams the vocab in tiles of ``tile_v`` columns with an online
log-sum-exp merge and saves only per-position scalars (each stream's lse,
the fused lse, b_row).  The backward recomputes each logits tile and
contracts its gradient straight into grad_h, grad_w and grad_b:

  d ce_row / d l_d,v = onehot_v - softmax(l_d)_v
  d b_row  / d l_d,v = p_v (u_v - lse(u) - b_row)

The merge differs from a one-pass log_softmax in float summation order only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mvc_tpu_torch.config import PAD_ID

_NEG = -1e30  # finite start of the running maxima: (m - m_new) * 0 stays 0


def _tiles(V: int, tile_v: int):
    """(offset, width) of each vocab tile; the last may be narrower."""
    return [(off, min(tile_v, V - off)) for off in range(0, V, tile_v)]


def _tile_logits(h, w, b, off, width, cdtype):
    return (h @ w[:, off:off + width].to(cdtype) + b[off:off + width].to(cdtype)).float()


class _FusedRows(torch.autograd.Function):
    """Per-position (ce_row, b_row), both [N] f32, from ``n`` streams given
    flat as (h_0, w_0, b_0, h_1, w_1, b_1, ...): h_d [N, H_d], w_d [H_d, V],
    b_d [V]; ``gold`` [N] int."""

    @staticmethod
    def forward(ctx, cdtype, tile_v, gold, *flat):
        n = len(flat) // 3
        hs = [flat[3 * d].to(cdtype) for d in range(n)]
        ws, bs = [flat[3 * d + 1] for d in range(n)], [flat[3 * d + 2] for d in range(n)]
        N, V = gold.shape[0], ws[0].shape[1]
        neg = torch.full((N,), _NEG, dtype=torch.float32, device=gold.device)
        zeros = torch.zeros((N,), dtype=torch.float32, device=gold.device)
        ms, s1s, picks = [neg] * n, [zeros] * n, [zeros] * n
        m_u, s1_u, s2_u = neg, zeros, zeros
        for off, width in _tiles(V, tile_v):
            loc = (gold - off).clamp(0, width - 1)[:, None]
            in_tile = (gold >= off) & (gold < off + width)
            u = None
            for d in range(n):
                l = _tile_logits(hs[d], ws[d], bs[d], off, width, cdtype)
                u = l if u is None else u + l
                m_t = l.amax(dim=-1)
                s1_t = torch.exp(l - m_t[:, None]).sum(dim=-1)
                m_new = torch.maximum(ms[d], m_t)
                s1s[d] = s1s[d] * torch.exp(ms[d] - m_new) + s1_t * torch.exp(m_t - m_new)
                ms[d] = m_new
                picks[d] = picks[d] + torch.where(in_tile, torch.gather(l, 1, loc)[:, 0], zeros)
            # the fused distribution: online max, sum and first moment
            # s2 = sum exp(u - m) * (u - m), rescaled on each merge
            m_t = u.amax(dim=-1)
            e = torch.exp(u - m_t[:, None])
            s1_t = e.sum(dim=-1)
            s2_t = (e * (u - m_t[:, None])).sum(dim=-1)
            m_new = torch.maximum(m_u, m_t)
            a, a_t = torch.exp(m_u - m_new), torch.exp(m_t - m_new)
            s2_u = a * (s2_u + (m_u - m_new) * s1_u) + a_t * (s2_t + (m_t - m_new) * s1_t)
            s1_u = s1_u * a + s1_t * a_t
            m_u = m_new
        lses = [ms[d] + torch.log(s1s[d]) for d in range(n)]
        ce_row = sum(picks[d] - lses[d] for d in range(n))
        lse_u = m_u + torch.log(s1_u)
        b_row = s2_u / s1_u - torch.log(s1_u)
        ctx.cdtype, ctx.tile_v, ctx.n = cdtype, tile_v, n
        ctx.save_for_backward(gold, lse_u, b_row, *flat, *lses)
        return ce_row, b_row

    @staticmethod
    def backward(ctx, c1, c2):
        cdtype, tile_v, n = ctx.cdtype, ctx.tile_v, ctx.n
        gold, lse_u, b_row, *rest = ctx.saved_tensors
        flat, lses = rest[:3 * n], rest[3 * n:]
        hs = [flat[3 * d].to(cdtype) for d in range(n)]
        ws, bs = [flat[3 * d + 1] for d in range(n)], [flat[3 * d + 2] for d in range(n)]
        N, V = gold.shape[0], ws[0].shape[1]
        c1 = torch.zeros_like(lse_u) if c1 is None else c1
        c2 = torch.zeros_like(lse_u) if c2 is None else c2
        gh = [torch.zeros((N, h.shape[1]), dtype=torch.float32, device=h.device) for h in hs]
        gw = [torch.empty(w.shape, dtype=w.dtype, device=w.device) for w in ws]
        gb = [torch.empty(b.shape, dtype=b.dtype, device=b.device) for b in bs]
        for off, width in _tiles(V, tile_v):
            col = torch.arange(off, off + width, device=gold.device)
            onehot = (col[None, :] == gold[:, None]).float()
            ls = [_tile_logits(hs[d], ws[d], bs[d], off, width, cdtype) for d in range(n)]
            u = sum(ls)
            p_u = torch.exp(u - lse_u[:, None])
            ent_part = c2[:, None] * p_u * (u - lse_u[:, None] - b_row[:, None])
            for d in range(n):
                p_d = torch.exp(ls[d] - lses[d][:, None])
                dl = c1[:, None] * (onehot - p_d) + ent_part            # [N, tV] f32
                dl_c = dl.to(cdtype)
                gw[d][:, off:off + width] = (hs[d].t() @ dl_c).to(gw[d].dtype)
                gb[d][off:off + width] = dl.sum(dim=0).to(gb[d].dtype)
                gh[d] += (dl_c @ ws[d][:, off:off + width].to(cdtype).t()).float()
        grads = []
        for d in range(n):
            grads += [gh[d].to(flat[3 * d].dtype), gw[d], gb[d]]
        return (None, None, None, *grads)


def ce_entropy_from_hiddens(hiddens: Sequence[torch.Tensor], outs: Sequence[dict],
                            captions: torch.Tensor,
                            sample_mask: Optional[torch.Tensor] = None,
                            compute_dtype=torch.bfloat16,
                            tile_v: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce, entropy) equal to ``losses.nll_loss`` / ``losses.entropy_loss``
    on the materialized outputs (vocab-axis entropy), without building them.
    ``hiddens``: per stream [L, B, H_d] with the zero row 0; ``outs``: per
    stream {"w": [H_d, V], "b": [V]}; positions [1:] enter the loss."""
    L, B = captions.shape
    gold = captions[1:].reshape(-1).long()                           # [N]
    flat = []
    for h, o in zip(hiddens, outs):
        if o["w"].shape[1] != outs[0]["w"].shape[1]:
            raise ValueError("the streams must share the vocab size")
        flat += [h[1:].reshape((L - 1) * B, h.shape[2]), o["w"], o["b"]]
    ce_row, b_row = _FusedRows.apply(compute_dtype, int(tile_v), gold, *flat)
    pad = (gold != PAD_ID).float()
    ce = -(ce_row * pad).sum() / torch.clamp(pad.sum(), min=1.0)
    per_col = (b_row * pad).reshape(L - 1, B).sum(dim=0)             # [B]
    if sample_mask is None:
        return ce, -per_col.mean()
    sm = sample_mask.to(per_col.dtype)
    return ce, -(per_col * sm).sum() / torch.clamp(sm.sum(), min=1.0)
