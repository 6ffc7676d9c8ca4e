"""Single-step LSTM / GRU cells (``mvc_tpu/models/rnn.py:30-110, 250-265``).

Gate layout follows torch's concatenated convention: LSTM gates i,f,g,o;
GRU gates r,z,n with the recurrent n-bias inside the reset product.
Weights are ``[in, G*H]`` / ``[H, G*H]`` (right-multiply).
"""

from __future__ import annotations

import torch

from mvc_tpu_torch.models.initializers import rnn_params


def wmat(w: torch.Tensor, dtype) -> torch.Tensor:
    """The weight in the compute dtype (a plain cast; int8 comes later)."""
    return w.to(dtype)


def init_rnn(gen, rnn_type: str, in_size: int, hidden_size: int,
             dtype=torch.float32, device="cpu"):
    if rnn_type not in ("LSTM", "GRU"):
        raise ValueError(f"rnn_type must be LSTM or GRU, got {rnn_type}")
    n_gates = 4 if rnn_type == "LSTM" else 3
    return rnn_params(gen, in_size, hidden_size, n_gates, dtype, device)


def lstm_step(params, x: torch.Tensor, state):
    """x: [B, in], state: (h, c) each [B, H] -> (h', (h', c'))."""
    h, c = state
    d = x.dtype
    gates = (x @ wmat(params["wi"], d) + h @ wmat(params["wh"], d)
             + (params["bi"] + params["bh"]).to(d))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, (h_new, c_new)


def gru_step(params, x: torch.Tensor, state: torch.Tensor):
    """x: [B, in], state: h [B, H] -> (h', h').
    torch GRU: n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""
    h = state
    d = x.dtype
    gi = x @ wmat(params["wi"], d) + params["bi"].to(d)
    gh = h @ wmat(params["wh"], d) + params["bh"].to(d)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * h
    return h_new, h_new


def lstm_step_pre(params, gi: torch.Tensor, state):
    """LSTM step from a precomputed input preactivation gi = x @ wi + bi."""
    h, c = state
    d = gi.dtype
    gates = gi + h @ wmat(params["wh"], d) + params["bh"].to(d)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, (h_new, c_new)


def gru_step_pre(params, gi: torch.Tensor, state):
    """GRU step from a precomputed input preactivation gi = x @ wi + bi."""
    h = state
    d = gi.dtype
    gh = h @ wmat(params["wh"], d) + params["bh"].to(d)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * h
    return h_new, h_new


def rnn_step(params, rnn_type: str, x, state):
    if rnn_type == "LSTM":
        return lstm_step(params, x, state)
    return gru_step(params, x, state)


def rnn_step_pre(params, rnn_type: str, gi, state):
    if rnn_type == "LSTM":
        return lstm_step_pre(params, gi, state)
    return gru_step_pre(params, gi, state)


def init_state(rnn_type: str, batch_size: int, hidden_size: int,
               dtype=torch.float32, device="cpu"):
    h = torch.zeros((batch_size, hidden_size), dtype=dtype, device=device)
    if rnn_type == "LSTM":
        return (h, h)
    return h


def state_hidden(rnn_type: str, state):
    """The h part of the state."""
    return state[0] if rnn_type == "LSTM" else state
