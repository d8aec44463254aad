"""The RNN factories.

Counterpart of ``apex_tpu/RNN/models.py``: ``LSTM``, ``GRU``, ``ReLU``,
``Tanh`` and ``mLSTM`` build a :class:`stackedRNN` (or a
:class:`bidirectionalRNN`) of that cell.  Inputs are seq-major;
``batch_first=True`` raises, as in the JAX package.  The weights are drawn
from ``generator`` (keyword-only, as the port's layers take it) and moved
to ``device``; ``dropout_generator`` draws the inter-layer dropout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cells import CELLS
from .RNNBackend import RNNCell, bidirectionalRNN, stackedRNN

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]


def _toRNNBackend(cell: str, input_size: int, hidden_size: int,
                  num_layers: int = 1, bias: bool = True,
                  batch_first: bool = False, dropout: float = 0.0,
                  bidirectional: bool = False,
                  output_size: Optional[int] = None, *, device=None,
                  generator: torch.Generator,
                  dropout_generator: Optional[torch.Generator] = None):
    if batch_first:
        raise NotImplementedError(
            "batch_first is not supported; inputs are seq-major (T, B, F)")
    _, gate_multiplier, n_states = CELLS[cell]
    proto = RNNCell(gate_multiplier, input_size, hidden_size, cell,
                    n_states, bias, output_size, device=device,
                    generator=generator)
    kind = bidirectionalRNN if bidirectional else stackedRNN
    return kind(proto, num_layers, dropout, generator=generator,
                dropout_generator=dropout_generator)


def _factory(cell: str):
    def make(input_size, hidden_size, num_layers=1, bias=True,
             batch_first=False, dropout=0.0, bidirectional=False,
             output_size=None, **kw):
        return _toRNNBackend(cell, input_size, hidden_size, num_layers,
                             bias, batch_first, dropout, bidirectional,
                             output_size, **kw)
    make.__name__ = make.__qualname__ = cell
    make.__doc__ = (f"A {cell} stack over (T, B, input_size) inputs (see "
                    f"the module doc).")
    return make


LSTM = _factory("LSTM")
GRU = _factory("GRU")
ReLU = _factory("ReLU")
Tanh = _factory("Tanh")
mLSTM = _factory("mLSTM")
