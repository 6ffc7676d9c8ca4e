"""Parameter initializers matching torch layer defaults
(``mvc_tpu/models/initializers.py``), drawn from an explicit
``torch.Generator``:

- Linear: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias
- LSTM/GRU: U(-1/sqrt(hidden), 1/sqrt(hidden)) for all weights/biases
- Embedding: N(0, 1)

Draws happen on the CPU (the generator's device) and are then moved, so a
seed gives the same weights on every device.  The bits differ from
``jax.random``'s; tests carry weights across with ``utils/jax_weights.py``.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, shape, bound, dtype, device):
    x = torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    return x.to(device=device, dtype=dtype)


def linear_params(gen: torch.Generator, in_size: int, out_size: int, bias: bool = True,
                  dtype=torch.float32, device="cpu"):
    """Weight stored as [in, out] (right-multiply: y = x @ w + b)."""
    bound = 1.0 / math.sqrt(in_size)
    p = {"w": _uniform(gen, (in_size, out_size), bound, dtype, device)}
    if bias:
        p["b"] = _uniform(gen, (out_size,), bound, dtype, device)
    return p


def embedding_params(gen: torch.Generator, vocab_size: int, embed_size: int,
                     dtype=torch.float32, device="cpu"):
    table = torch.randn((vocab_size, embed_size), generator=gen, dtype=torch.float32)
    return {"table": table.to(device=device, dtype=dtype)}


def rnn_params(gen: torch.Generator, in_size: int, hidden_size: int, n_gates: int,
               dtype=torch.float32, device="cpu"):
    """Input/hidden weights as [in, G*H] / [H, G*H] with separate input/hidden
    biases (torch RNN layout, gate-concatenated)."""
    bound = 1.0 / math.sqrt(hidden_size)
    g = n_gates * hidden_size
    return {
        "wi": _uniform(gen, (in_size, g), bound, dtype, device),
        "wh": _uniform(gen, (hidden_size, g), bound, dtype, device),
        "bi": _uniform(gen, (g,), bound, dtype, device),
        "bh": _uniform(gen, (g,), bound, dtype, device),
    }
