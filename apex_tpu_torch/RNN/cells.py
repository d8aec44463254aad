"""Cell step functions.

Counterpart of ``apex_tpu/RNN/cells.py``.  Each cell is a function
``cell(params, hidden, x) -> (new_hidden, out)`` over one time step,
``params`` a mapping of the layer's tensors (``w_ih``, ``w_hh``, the
optional ``b_ih``/``b_hh``, mLSTM's ``w_mx``/``w_mh``).  The gate matmuls
go through the policy-aware ``nn.functional.linear``, so amp O1 casts
them.  LSTM gates are in the order (i, f, g, o); the LSTM and mLSTM cell
state is formed in the gates' dtype and stored back in its own.
"""

from __future__ import annotations

import torch

from ..nn import functional as F

__all__ = ["lstm_cell", "gru_cell", "relu_cell", "tanh_cell", "mlstm_cell",
           "CELLS"]


def lstm_cell(params, hidden, x):
    h, c = hidden
    gates = F.linear(x, params["w_ih"], params.get("b_ih")) + \
        F.linear(h, params["w_hh"], params.get("b_hh"))
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c32 = f * c.to(g.dtype) + i * g
    h_new = o * torch.tanh(c32)
    return (h_new, c32.to(c.dtype)), h_new


def gru_cell(params, hidden, x):
    (h,) = hidden
    gi = F.linear(x, params["w_ih"], params.get("b_ih"))
    gh = F.linear(h, params["w_hh"], params.get("b_hh"))
    ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    h_new = (1 - z) * n + z * h
    return (h_new,), h_new


def relu_cell(params, hidden, x):
    (h,) = hidden
    h_new = F.relu(F.linear(x, params["w_ih"], params.get("b_ih")) +
                   F.linear(h, params["w_hh"], params.get("b_hh")))
    return (h_new,), h_new


def tanh_cell(params, hidden, x):
    (h,) = hidden
    h_new = torch.tanh(F.linear(x, params["w_ih"], params.get("b_ih")) +
                       F.linear(h, params["w_hh"], params.get("b_hh")))
    return (h_new,), h_new


def mlstm_cell(params, hidden, x):
    """Multiplicative LSTM (Krause et al.): m = (W_mx x) * (W_mh h), then
    the LSTM gates driven by (x, m)."""
    h, c = hidden
    m = F.linear(x, params["w_mx"]) * F.linear(h, params["w_mh"])
    gates = F.linear(x, params["w_ih"], params.get("b_ih")) + \
        F.linear(m, params["w_hh"], params.get("b_hh"))
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c.to(g.dtype) + i * g
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new.to(c.dtype)), h_new


CELLS = {
    "LSTM": (lstm_cell, 4, 2),      # (fn, gate_multiplier, n_hidden_states)
    "GRU": (gru_cell, 3, 1),
    "ReLU": (relu_cell, 1, 1),
    "Tanh": (tanh_cell, 1, 1),
    "mLSTM": (mlstm_cell, 4, 2),
}
