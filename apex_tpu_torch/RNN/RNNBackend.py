"""The recurrent stack.

Counterpart of ``apex_tpu/RNN/RNNBackend.py``.  :class:`RNNCell` holds one
layer's weights (``gate_multiplier`` x hidden gates, mLSTM's ``w_mx`` and
``w_mh``, and the optional ``w_ho`` output projection, which feeds the
projected output back as the recurrent state); :class:`stackedRNN` runs
its layers in turn, each a Python loop over time (the JAX package's
``lax.scan``), with dropout between layers in train mode, drawn from an
explicit generator on the activations' device (it matches the JAX
package's in distribution only); :class:`bidirectionalRNN` runs a
forward stack and a stack over the reversed sequence and concatenates
their features, the reversed outputs flipped back.

Inputs are seq-major (T, B, F).  A forward returns ``(out, hidden)``;
the hidden state is passed in and out, not kept on the module.  Weights
are drawn uniform in +-1/sqrt(hidden_size) on the CPU from ``generator``
and moved to ``device``; the parameters of a stack are named as the JAX
package's params tree (``rnns.0.w_ih``, ``fwd.rnns.0.w_ih``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..nn import functional as F
from .cells import CELLS

__all__ = ["RNNCell", "stackedRNN", "bidirectionalRNN"]


class RNNCell(torch.nn.Module):
    """One recurrent layer's weights and its loop over time."""

    def __init__(self, gate_multiplier: int, input_size: int,
                 hidden_size: int, cell: str, n_hidden_states: int = 2,
                 bias: bool = True, output_size: Optional[int] = None, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.gate_multiplier = gate_multiplier
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.cell = cell
        self.n_hidden_states = n_hidden_states
        self.bias = bias
        self.output_size = (output_size if output_size is not None
                            else hidden_size)
        if self.output_size != hidden_size and cell == "GRU":
            # GRU's update gate mixes h elementwise with gate-space
            # tensors, so a projected recurrent state is ill-defined
            raise NotImplementedError(
                "output_size projection is not defined for GRU")
        gh = gate_multiplier * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)

        def u(*shape):
            w = torch.empty(shape, dtype=torch.float32)
            w.uniform_(-bound, bound, generator=generator)
            return torch.nn.Parameter(w.to(device))

        self.w_ih = u(gh, input_size)
        self.w_hh = u(gh, self.output_size)
        if bias:
            self.b_ih = u(gh)
            self.b_hh = u(gh)
        if cell == "mLSTM":
            self.w_mx = u(self.output_size, input_size)
            self.w_mh = u(self.output_size, self.output_size)
        if self.output_size != hidden_size:
            self.w_ho = u(self.output_size, hidden_size)

    def init_hidden(self, batch: int, dtype=torch.float32, device=None):
        """Zeros: hidden[0] (the recurrent output) is output_size wide,
        deeper states (the LSTM cell state) hidden_size."""
        shapes = [(batch, self.output_size)] + \
            [(batch, self.hidden_size)] * (self.n_hidden_states - 1)
        return tuple(torch.zeros(s, dtype=dtype, device=device)
                     for s in shapes)

    def forward(self, x, hidden=None):
        """x: (T, B, F). Returns (out (T, B, output_size), final hidden)."""
        fn = CELLS[self.cell][0]
        params = {k: p for k, p in self._parameters.items() if p is not None}
        h = (self.init_hidden(x.shape[1], x.dtype, x.device)
             if hidden is None else tuple(hidden))
        w_ho = params.get("w_ho")
        outs = []
        for t in range(x.shape[0]):
            h, out = fn(params, h, x[t])
            if w_ho is not None:
                out = F.linear(out, w_ho)
                h = (out,) + tuple(h[1:])
            outs.append(out)
        return torch.stack(outs), h


class stackedRNN(torch.nn.Module):
    """``num_layers`` cells in sequence: ``inputRNN``, then cells of its
    kind over its output width drawn from ``generator``; dropout between
    layers in train mode, drawn from ``dropout_generator``."""

    def __init__(self, inputRNN: RNNCell, num_layers: int = 1,
                 dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        if num_layers > 1 and generator is None:
            raise ValueError("a stack of more layers than its first draws "
                             "their weights from generator=")
        device = inputRNN.w_ih.device
        cells = [inputRNN]
        for _ in range(num_layers - 1):
            cells.append(RNNCell(
                inputRNN.gate_multiplier, inputRNN.output_size,
                inputRNN.hidden_size, inputRNN.cell,
                inputRNN.n_hidden_states, inputRNN.bias,
                inputRNN.output_size, device=device, generator=generator))
        self.rnns = torch.nn.ModuleList(cells)

    def forward(self, x, hidden=None):
        hiddens = []
        for i, cell in enumerate(self.rnns):
            x, h_out = cell(x, hidden[i] if hidden is not None else None)
            hiddens.append(h_out)
            if self.dropout and i < self.num_layers - 1 and self.training:
                x = F.dropout(x, self.dropout, self.dropout_generator)
        return x, hiddens


class bidirectionalRNN(torch.nn.Module):
    """A forward stack and a stack over the reversed sequence, their
    features concatenated."""

    def __init__(self, inputRNN: RNNCell, num_layers: int = 1,
                 dropout: float = 0.0, *, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fwd = stackedRNN(inputRNN, num_layers, dropout,
                              generator=generator,
                              dropout_generator=dropout_generator)
        bwd_proto = RNNCell(inputRNN.gate_multiplier, inputRNN.input_size,
                            inputRNN.hidden_size, inputRNN.cell,
                            inputRNN.n_hidden_states, inputRNN.bias,
                            inputRNN.output_size,
                            device=inputRNN.w_ih.device, generator=generator)
        self.bwd = stackedRNN(bwd_proto, num_layers, dropout,
                              generator=generator,
                              dropout_generator=dropout_generator)

    def forward(self, x, hidden=None):
        fwd_out, fwd_h = self.fwd(x, hidden[0] if hidden else None)
        bwd_out, bwd_h = self.bwd(torch.flip(x, dims=(0,)),
                                  hidden[1] if hidden else None)
        out = torch.cat([fwd_out, torch.flip(bwd_out, dims=(0,))], dim=-1)
        return out, (fwd_h, bwd_h)
