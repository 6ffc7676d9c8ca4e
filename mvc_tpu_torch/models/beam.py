"""Batched beam search (``mvc_tpu/models/beam.py:41-125``), a Python loop
over time with static ``[B, W, ...]`` state tensors.  Semantics as the JAX
scan, which replicates the reference's beam search:

- log-probs of finished beams are zeroed before the cumulative score is
  added, so every expansion of a finished beam scores ``cum``
- GNMT length normalization ``((5 + len)^alpha) / 6^alpha`` where ``len``
  is the step of the first EOS + 1, else ``t + 1``
- top-W over the flattened ``W * V`` candidates, ties to the lowest flat
  index; beam = index // V, token = index % V
- the selected *unnormalized* score becomes the new cumulative score
- ``max_caption_len + 1`` steps, stopping after the one step that begins
  with every beam finished (every later step would only re-sort beams and
  write token 0); the result is ``[SOS] + beam 0's tokens``

This is the CPU path of ``predict_tokens(mode="beam")`` of the RNN
captioners, whose search on the card runs in ``ops/beam.py``'s kernel, and
the transformer's beam on either device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mvc_tpu_torch.config import EOS_ID, SOS_ID

NEG_INF = -1e9   # dead-beam start score: finite, so the normalization stays NaN-free

# step_fn(prev_tokens [B, W], state) -> (log_probs [B, W, V] float32, new_state)
StepFn = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


def _regather(x, beam_idx):
    """x[b, beam_idx[b, k]] for every [B, W, ...] leaf of a state tree
    (tuples, lists and dicts); leaves without the beam axes (a step
    counter, a Python number) pass through, as in the JAX search."""
    if isinstance(x, (tuple, list)):
        return type(x)(_regather(v, beam_idx) for v in x)
    if isinstance(x, dict):
        return {k: _regather(v, beam_idx) for k, v in x.items()}
    if not isinstance(x, torch.Tensor) or x.dim() < 2 or x.shape[:2] != beam_idx.shape:
        return x
    idx = beam_idx.reshape(*beam_idx.shape, *([1] * (x.dim() - 2))).expand(
        *beam_idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list, dict)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def beam_search(step_fn: StepFn, init_state, batch_size: int, vocab_size: int,
                max_caption_len: int = 30, beam_alpha: float = 0.0,
                beam_width: int = 5) -> torch.Tensor:
    """Returns token ids [B, max_caption_len + 2] (int32) beginning with SOS,
    on the device of ``init_state``'s tensors."""
    B, W, V = batch_size, beam_width, vocab_size
    device = _first_tensor(init_state).device
    Lh = max_caption_len + 1
    prev = torch.full((B, W), SOS_ID, dtype=torch.long, device=device)
    # only beam 0 is live at the start; the replicas carry NEG_INF scores
    cum = torch.where(torch.arange(W, device=device) == 0, 0.0, NEG_INF).to(
        torch.float32).repeat(B, 1)
    hist = torch.zeros((B, W, Lh), dtype=torch.int32, device=device)
    finished = torch.zeros((B, W), dtype=torch.bool, device=device)
    eos_len = torch.zeros((B, W), dtype=torch.int32, device=device)
    state = init_state
    for t in range(Lh):
        began_allfin = bool(finished.all())
        log_probs, state = step_fn(prev, state)                               # [B, W, V]
        cand = torch.where(finished[:, :, None], 0.0, log_probs) + cum[:, :, None]
        lens = torch.where(finished, eos_len, t + 1).to(torch.float32)
        norm = ((5.0 + lens) ** beam_alpha) / (6.0 ** beam_alpha)
        flat_norm = (cand / norm[:, :, None]).reshape(B, W * V)
        # a stable descending sort: equal scores keep the lowest flat index first
        top = torch.sort(flat_norm, dim=1, descending=True, stable=True)[1][:, :W]
        beam_idx = top // V
        token = (top % V).to(torch.int32)
        cum = torch.gather(cand.reshape(B, W * V), 1, top)
        state = _regather(state, beam_idx)
        hist = _regather(hist, beam_idx)
        hist[:, :, t] = token
        prev_finished = _regather(finished, beam_idx)
        prev_eos_len = _regather(eos_len, beam_idx)
        finished = prev_finished | (token == EOS_ID)
        eos_len = torch.where(prev_finished, prev_eos_len,
                              torch.where(token == EOS_ID, t + 1, 0).to(torch.int32))
        prev = token.long()
        if began_allfin:
            break
    sos = torch.full((B, 1), SOS_ID, dtype=torch.int32, device=device)
    return torch.cat([sos, hist[:, 0, :]], dim=1)
