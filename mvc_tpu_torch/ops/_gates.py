"""Shared RNN gate update (``mvc_tpu/ops/_gates.py:17-45``): the plain
PyTorch twin of ``gate_update`` in ``csrc/gates.cuh``, which the decode
kernels call per hidden unit.  Torch gate order: LSTM i,f,g,o; GRU r,z,n
with the recurrent n-bias kept inside the reset product."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def apply_gates(cell: str, gv: torch.Tensor, gh: Optional[torch.Tensor],
                h_prev: torch.Tensor, c: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One step's gate math over [B, G*H] float32 preactivations.

    LSTM: ``gv`` is the complete preactivation (x-side + h-side + bi + bh);
    ``gh`` is unused.  GRU: ``gv`` = x-side + bi, ``gh`` = h-side + bh.
    Returns (h_new, c_new); ``c_new`` is None for a GRU."""
    if cell == "LSTM":
        i, f, g, o = gv.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    x_r, x_z, x_n = gv.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    n = torch.tanh(x_n + r * h_n)
    return (1.0 - z) * n + z * h_prev, None
