"""The benchmark's own yardstick: FLOPs and bytes counted from shapes, and
the card's published peaks.

Counts are 2 FLOPs a multiply-add of the matrix products a decoder or a
train step needs; element-wise work (tanh, sigmoid, softmax) is not
counted.  Bytes are each input read once and each output written once.

The decoder's context enters the cell through ``context @ wi_ctx``, which
is linear in the features, so two exact formulations exist: the context
first and then its projection (T*F a row and step, plus F*4H), or every
frame projected once (T*F*4H a clip, plus T*4H a row and step).  Each
count takes whichever the shapes make cheaper, whatever the program
runs, so the same work reads the same whatever implements it and no
formulation can read above its peak.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# NVIDIA H100 SXM data sheet at its full 700 W (dense): float32 outside the
# tensor cores, which is what every cell runs (TF32 off), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Dec:
    """One decoder's widths: features F, embedding E, hidden H, attention A,
    vocabulary V, gates G (4: LSTM)."""

    F: int
    E: int
    H: int
    A: int
    V: int
    G: int = 4

    @property
    def params(self) -> int:
        GH = self.G * self.H
        return (self.V * self.E + self.H * self.A + self.F * self.A + 2 * self.A
                + (self.E + self.F) * GH + self.H * GH + 2 * GH + self.H * self.V + self.V)


def context_flops(T: int, F: int, GH: int, clips: int, row_steps: int) -> int:
    """The cheaper of the two exact formulations of the context's way into
    the gates, for ``clips`` clips of T frames and ``row_steps`` (row,
    step) pairs over them."""
    first = row_steps * (2 * T * F + 2 * F * GH)
    projected = clips * 2 * T * F * GH + row_steps * 2 * T * GH
    return min(first, projected)


def decode_flops(decs: Sequence[Dec], T: int, clips: int, rows_per_clip: int, steps: int) -> int:
    """FLOPs of a decode of ``clips`` clips of T frames, ``rows_per_clip``
    rows a clip (1: direct; W: beam), ``steps`` steps a row: the attention
    keys once a clip, then per row and step the query, energies, the
    context's way into the gates, the embedding and recurrent gates and
    the vocabulary projection, for each decoder."""
    row_steps = clips * rows_per_clip * steps
    total = 0
    for d in decs:
        GH = d.G * d.H
        total += clips * 2 * T * d.F * d.A
        total += row_steps * (2 * d.H * d.A + 2 * T * d.A + 2 * d.E * GH + 2 * d.H * GH
                              + 2 * d.H * d.V)
        total += context_flops(T, d.F, GH, clips, row_steps)
    return total


def decode_bytes(decs: Sequence[Dec], feat_dim: int, B: int, T: int, out_cols: int) -> int:
    """Bytes of one decode call over [B, T] float32 features of
    ``feat_dim`` and a float32 mask: features, mask and every weight read
    once, the int32 tokens written once."""
    return (B * T * feat_dim * 4 + B * T * 4 + sum(d.params for d in decs) * 4
            + B * out_cols * 4)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the float32 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def reconstructor_flops(F: int, H_dec: int, steps: int, rows: int) -> int:
    """A global RecNet reconstructor's forward: per row and step an LSTM of
    width F over [decoder hidden | mean hidden] (2*H_dec) and its own
    state."""
    GH = 4 * F
    return rows * steps * (2 * 2 * H_dec * GH + 2 * F * GH)


def train_step_flops(decs: Sequence[Dec], T: int, L: int, B: int) -> int:
    """3x the forward's FLOPs of one teacher-forced train step over B
    samples of T frames and L caption tokens (L-1 steps): each decoder's
    decode and vocabulary projection, and its global reconstructor (each
    backward GEMM pair costs twice its forward)."""
    fwd = decode_flops(decs, T, B, 1, L - 1)
    for d in decs:
        fwd += reconstructor_flops(d.F, d.H, L - 1, B)
    return 3 * fwd
