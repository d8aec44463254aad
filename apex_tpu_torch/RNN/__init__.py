"""The recurrent stack: the ``LSTM``, ``GRU``, ``ReLU``, ``Tanh`` and
``mLSTM`` factories over ``RNNCell``, ``stackedRNN`` and
``bidirectionalRNN`` (counterpart of ``apex_tpu/RNN``)."""

from . import cells
from .models import GRU, LSTM, ReLU, Tanh, mLSTM
from .RNNBackend import RNNCell, bidirectionalRNN, stackedRNN

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "RNNCell", "stackedRNN",
           "bidirectionalRNN", "cells"]
