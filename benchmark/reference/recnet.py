"""Plain float32 reference of the benchmark's captioners, from the layer
equations of SA-LSTM soft attention (Yao et al., ICCV 2015,
arXiv:1502.08029) and RecNet's decoders (Wang et al., CVPR 2018,
arXiv:1803.11438) as ``hmartelb/multimodal-video-captioning``
``src/models/captioning.py`` composes them.

One decoder step, for rows that attend over the same clip::

    q   = h W                              energies_t = w . tanh(q + U v_t + b)
    a   = softmax_t(energies)              context    = sum_t a_t v_t
    z   = [E[prev] | context] wi + bi + h wh + bh       (LSTM gates i, f, g, o)
    c'  = s(f) c + s(i) tanh(g)            h' = s(o) tanh(c')
    log p = log_softmax(h' Wout + bout)

The dual model (late fusion) sums its two decoders' log-probs; in direct
mode each decoder feeds back its own argmax and the caption takes the
argmax of the sum; in beam mode one search runs over the sum.  Each clip
is computed at its own length, with no padding and no mask.

It imports torch alone, nothing of the program, and takes the parameter
tree the benchmark made (``benchmark/harness/weights.py``).  It runs in
float32 with TF32 off unless a caller asks for the control's TF32
(``precision``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

SOS_ID, EOS_ID = 1, 2
NEG_INF = -1e9


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products with TF32 off (the reference), or on (the
    control, the nearest precision below the configuration's)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _step(p, feats, keys, prev, h, c):
    """One LSTM decoder step for n clips of one length and R rows a clip.
    feats [n, T, F], keys [n, T, A], prev [n, R], h and c [n, R, H].
    Returns (log-probs [n, R, V], h', c')."""
    att = p["attention"]
    q = h @ att["W"]                                                   # [n, R, A]
    energies = torch.tanh(q[:, :, None, :] + keys[:, None] + att["b"]) @ att["w"]
    weights = torch.softmax(energies, dim=-1)                          # [n, R, T]
    context = torch.einsum("nrt,ntf->nrf", weights, feats)
    x = torch.cat([p["embedding"]["table"][prev], context], dim=-1)
    rnn = p["rnn"]
    z = x @ rnn["wi"] + rnn["bi"] + h @ rnn["wh"] + rnn["bh"]
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    logits = h @ p["out"]["w"] + p["out"]["b"]
    return torch.log_softmax(logits, dim=-1), h, c


class _Clips:
    """The decoders' operands for n clips of one length."""

    def __init__(self, decoders: Sequence[Dict], feats: Sequence[torch.Tensor]):
        self.decoders = list(decoders)
        self.feats = [f.float() for f in feats]
        self.keys = [f @ p["attention"]["U"] for p, f in zip(self.decoders, self.feats)]
        self.n = self.feats[0].shape[0]
        self.H = [p["rnn"]["wh"].shape[0] for p in self.decoders]

    def zeros(self, rows: int):
        dev = self.feats[0].device
        return [torch.zeros((self.n, rows, h), device=dev) for h in self.H]

    def step(self, prevs, hs, cs):
        out = [_step(p, f, k, prev, h, c) for p, f, k, prev, h, c
               in zip(self.decoders, self.feats, self.keys, prevs, hs, cs)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def greedy(decoders, feats, steps: int) -> torch.Tensor:
    """Direct-mode tokens [n, steps]: each decoder feeds back its own
    argmax, the caption takes the argmax of the summed log-probs."""
    clips = _Clips(decoders, feats)
    hs, cs = clips.zeros(1), clips.zeros(1)
    prevs = [torch.full((clips.n, 1), SOS_ID, dtype=torch.long, device=hs[0].device)
             for _ in decoders]
    out = []
    for _ in range(steps):
        logps, hs, cs = clips.step(prevs, hs, cs)
        prevs = [lp.argmax(dim=-1) for lp in logps]
        out.append(sum(logps).argmax(dim=-1)[:, 0])
    return torch.stack(out, dim=1)


def greedy_gaps(decoders, feats, served: torch.Tensor, lengths: torch.Tensor,
                tie: float = 0.0):
    """For each clip, the widest gap (nats) by which a served token's summed
    log-prob lies below the best at its step, over its first ``lengths``
    served tokens.  The decoders run as the model defines direct mode:
    with one decoder the served token is fed back; with two, each feeds
    back its own argmax (the caption never feeds the decoders).

    A decoder's own pick whose two best log-probs lie within ``tie`` of
    each other is a tie to rounding: which way it went is not the
    reference's to say, so the clip's later positions, which follow from
    it, are not compared.  served [n, S] long, lengths [n].  Returns
    (widest gap [n], positions compared [n])."""
    clips = _Clips(decoders, feats)
    hs, cs = clips.zeros(1), clips.zeros(1)
    dev = hs[0].device
    prevs = [torch.full((clips.n, 1), SOS_ID, dtype=torch.long, device=dev) for _ in decoders]
    worst = torch.zeros(clips.n, device=dev)
    compared = torch.zeros(clips.n, dtype=torch.long, device=dev)
    open_ = torch.ones(clips.n, dtype=torch.bool, device=dev)
    for t in range(int(lengths.max())):
        logps, hs, cs = clips.step(prevs, hs, cs)
        fused = sum(logps)[:, 0]                                       # [n, V]
        tok = served[:, t].clamp(min=0)
        gap = fused.max(dim=-1).values - fused.gather(1, tok[:, None])[:, 0]
        use = open_ & (t < lengths)
        worst = torch.where(use, torch.maximum(worst, gap), worst)
        compared += use.long()
        if len(decoders) == 1:
            prevs = [tok[:, None]]
        else:
            prevs = [lp.argmax(dim=-1) for lp in logps]
            for lp in logps:
                top2 = lp[:, 0].topk(2, dim=-1).values
                open_ &= (top2[:, 0] - top2[:, 1]) >= tie
    return worst, compared


def beam(decoders, feats, width: int, max_caption_len: int, alpha: float = 0.0):
    """Beam search over the summed log-probs (the reference's search:
    finished beams score their cumulative score, GNMT length normalization,
    top-W of the W*V candidates, ties to the lowest flat index,
    ``max_caption_len + 1`` steps).  Returns (tokens [n, max_caption_len + 2]
    beginning with SOS, the best beam's cumulative score [n], margin [n]):
    a clip's margin is the least gap between its W-th and (W+1)-th
    candidates over the steps, or its two best beams' at the last; below
    rounding's reach it is a tie whose way is not the reference's to say."""
    clips = _Clips(decoders, feats)
    n, W = clips.n, int(width)
    dev = clips.feats[0].device
    steps = int(max_caption_len) + 1
    hs, cs = clips.zeros(W), clips.zeros(W)
    prev = torch.full((n, W), SOS_ID, dtype=torch.long, device=dev)
    cum = torch.where(torch.arange(W, device=dev) == 0, 0.0, NEG_INF).repeat(n, 1)
    hist = torch.zeros((n, W, steps), dtype=torch.long, device=dev)
    finished = torch.zeros((n, W), dtype=torch.bool, device=dev)
    eos_len = torch.zeros((n, W), dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    margin = torch.full((n,), float("inf"), device=dev)
    for t in range(steps):
        began_finished = bool(finished.all())
        logps, hs, cs = clips.step([prev] * len(decoders), hs, cs)
        fused = sum(logps)                                              # [n, W, V]
        V = fused.shape[-1]
        cand = torch.where(finished[:, :, None], 0.0, fused) + cum[:, :, None]
        lens = torch.where(finished, eos_len, t + 1).float()
        norm = ((5.0 + lens) ** alpha) / (6.0 ** alpha)
        flat = (cand / norm[:, :, None]).reshape(n, W * V)
        ranked, order = torch.sort(flat, dim=1, descending=True, stable=True)
        margin = torch.minimum(margin, ranked[:, W - 1] - ranked[:, W])
        top = order[:, :W]
        src, token = top // V, top % V
        cum = cand.reshape(n, W * V).gather(1, top)
        hs = [h[rows, src] for h in hs]
        cs = [c[rows, src] for c in cs]
        hist = hist[rows, src]
        hist[:, :, t] = token
        was_finished, was_len = finished[rows, src], eos_len[rows, src]
        finished = was_finished | (token == EOS_ID)
        eos_len = torch.where(was_finished, was_len, torch.where(token == EOS_ID, t + 1, 0))
        prev = token
        if began_finished:
            break
    sos = torch.full((n, 1), SOS_ID, dtype=torch.long, device=dev)
    margin = torch.minimum(margin, ranked[:, 0] - ranked[:, 1])
    return torch.cat([sos, hist[:, 0]], dim=1), cum[:, 0], margin


def by_length(lengths: Sequence[int]) -> Dict[int, List[int]]:
    """Indices grouped by clip length, so each group runs unpadded."""
    groups: Dict[int, List[int]] = {}
    for i, t in enumerate(lengths):
        groups.setdefault(int(t), []).append(i)
    return groups
