"""LSTM / GRU cells and the whole-sequence scan over precomputed input
preactivations (``mvc_tpu/models/rnn.py``).

Gate layout follows torch's concatenated convention: LSTM gates i,f,g,o;
GRU gates r,z,n with the recurrent n-bias inside the reset product.
Weights are ``[in, G*H]`` / ``[H, G*H]`` (right-multiply).
"""

from __future__ import annotations

import torch

from mvc_tpu_torch.models.initializers import rnn_params


def wmat(w: torch.Tensor, dtype) -> torch.Tensor:
    """The weight in the compute dtype: a plain cast (the captioners
    dequantize an int8 tree once per call, ``ops/quant.py``)."""
    return w.to(dtype)


def init_lstm(gen: torch.Generator, in_size: int, hidden_size: int, dtype=torch.float32,
              device="cpu"):
    """An LSTM's weights and biases (4 gates) drawn from ``gen``."""
    return rnn_params(gen, in_size, hidden_size, 4, dtype, device)


def init_gru(gen: torch.Generator, in_size: int, hidden_size: int, dtype=torch.float32,
             device="cpu"):
    """A GRU's weights and biases (3 gates) drawn from ``gen``."""
    return rnn_params(gen, in_size, hidden_size, 3, dtype, device)


def init_rnn(gen, rnn_type: str, in_size: int, hidden_size: int,
             dtype=torch.float32, device="cpu"):
    if rnn_type not in ("LSTM", "GRU"):
        raise ValueError(f"rnn_type must be LSTM or GRU, got {rnn_type}")
    init = init_lstm if rnn_type == "LSTM" else init_gru
    return init(gen, in_size, hidden_size, dtype, device)


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


def rnn_input_preact(params, rnn_type: str, x: torch.Tensor) -> torch.Tensor:
    """Input-side gate preactivation ``x @ wi + bi`` ([..., G*H]), the same
    for LSTM and GRU.  Linear in x, so a whole known input sequence takes
    one batched GEMM before the recurrence."""
    del rnn_type
    d = x.dtype
    return x @ wmat(params["wi"], d) + params["bi"].to(d)


class _LSTMScanPre(torch.autograd.Function):
    """LSTM recurrence over precomputed input preactivations.  The forward
    saves the per-step gates; the backward runs the reverse recurrence on
    [B, H] carries only and forms ``dwh`` as ONE stacked GEMM over all
    steps (``mvc_tpu/models/rnn.py:112-164``)."""

    @staticmethod
    def forward(ctx, wh, bh, gi_all, h0, c0):
        d = gi_all.dtype
        wh_d, bh_d = wh.to(d), bh.to(d)
        h, c = h0, c0
        hs, saved = [], []
        for t in range(gi_all.shape[0]):
            gates = gi_all[t] + h @ wh_d + bh_d
            i, f, g, o = gates.chunk(4, dim=-1)
            si, sf = torch.sigmoid(i), torch.sigmoid(f)
            tg, so = torch.tanh(g), torch.sigmoid(o)
            c_new = sf * c + si * tg
            h_new = so * torch.tanh(c_new)
            saved.append((si, sf, tg, so, h, c, c_new))
            h, c = h_new, c_new
            hs.append(h_new)
        stacked = [torch.stack(x) for x in zip(*saved)]
        ctx.save_for_backward(wh, bh, *stacked)
        return torch.stack(hs)

    @staticmethod
    def backward(ctx, dhs):
        wh, bh, si, sf, tg, so, h_prev, c_prev, c_new = ctx.saved_tensors
        d = si.dtype
        wh_t = wh.to(d).t()
        L, B, H = dhs.shape
        dh_rec = torch.zeros((B, H), dtype=d, device=dhs.device)
        dc_rec = torch.zeros_like(dh_rec)
        dgates = [None] * L
        for t in range(L - 1, -1, -1):
            dh = dh_rec + dhs[t].to(d)
            tc = torch.tanh(c_new[t])
            dc = dc_rec + dh * so[t] * (1.0 - tc * tc)
            dg = torch.cat([
                dc * tg[t] * si[t] * (1.0 - si[t]),          # d i_pre
                dc * c_prev[t] * sf[t] * (1.0 - sf[t]),      # d f_pre
                dc * si[t] * (1.0 - tg[t] * tg[t]),          # d g_pre
                dh * tc * so[t] * (1.0 - so[t]),             # d o_pre
            ], dim=-1)
            dgates[t] = dg
            dh_rec, dc_rec = dg @ wh_t, dc * sf[t]
        dgates = torch.stack(dgates)
        GH = dgates.shape[-1]
        dwh = (h_prev.reshape(L * B, H).t() @ dgates.reshape(L * B, GH)).to(wh.dtype)
        dbh = dgates.sum(dim=(0, 1)).to(bh.dtype)
        return dwh, dbh, dgates, dh_rec, dc_rec


class _GRUScanPre(torch.autograd.Function):
    """GRU counterpart of ``_LSTMScanPre`` (``mvc_tpu/models/rnn.py:167-215``)."""

    @staticmethod
    def forward(ctx, wh, bh, gi_all, h0):
        d = gi_all.dtype
        wh_d, bh_d = wh.to(d), bh.to(d)
        h = h0
        hs, saved = [], []
        for t in range(gi_all.shape[0]):
            gh = h @ wh_d + bh_d
            i_r, i_z, i_n = gi_all[t].chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h_new = (1.0 - z) * n + z * h
            saved.append((r, z, n, h, h_n))
            h = h_new
            hs.append(h_new)
        stacked = [torch.stack(x) for x in zip(*saved)]
        ctx.save_for_backward(wh, bh, *stacked)
        return torch.stack(hs)

    @staticmethod
    def backward(ctx, dhs):
        wh, bh, r, z, n, h_prev, h_n = ctx.saved_tensors
        d = r.dtype
        wh_t = wh.to(d).t()
        L, B, H = dhs.shape
        dh_rec = torch.zeros((B, H), dtype=d, device=dhs.device)
        dgi, dgh = [None] * L, [None] * L
        for t in range(L - 1, -1, -1):
            dh = dh_rec + dhs[t].to(d)
            dz_pre = dh * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
            dn_pre = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr_pre = dn_pre * h_n[t] * r[t] * (1.0 - r[t])
            dgi[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
            dgh[t] = torch.cat([dr_pre, dz_pre, dn_pre * r[t]], dim=-1)
            dh_rec = dgh[t] @ wh_t + dh * z[t]
        dgi, dgh = torch.stack(dgi), torch.stack(dgh)
        GH = dgh.shape[-1]
        dwh = (h_prev.reshape(L * B, H).t() @ dgh.reshape(L * B, GH)).to(wh.dtype)
        dbh = dgh.sum(dim=(0, 1)).to(bh.dtype)
        return dwh, dbh, dgi, dh_rec


def rnn_scan_pre(params, rnn_type: str, gi_all: torch.Tensor, init_state) -> torch.Tensor:
    """Whole-sequence RNN from precomputed input preactivations ``gi_all``
    [L, B, G*H] (``mvc_tpu/models/rnn.py:220``): the hidden sequence of
    stepping ``rnn_step_pre``, with a backward that forms the recurrent
    weight gradient as one [H, L*B] x [L*B, G*H] GEMM instead of
    accumulating it step by step.  Returns hiddens [L, B, H]."""
    if rnn_type == "LSTM":
        h0, c0 = init_state
        return _LSTMScanPre.apply(params["wh"], params["bh"], gi_all, h0, c0)
    return _GRUScanPre.apply(params["wh"], params["bh"], gi_all, init_state)
