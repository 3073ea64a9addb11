"""Layers package (counterpart of paddle_tpu/layers/)."""
from . import nn, rnn, tensor  # noqa: F401
from .nn import *  # noqa: F401,F403
from .rnn import (dynamic_gru, dynamic_lstm, gru_unit,  # noqa: F401
                  lstm_layer, lstm_unit)
from .tensor import assign, cast, concat, sums  # noqa: F401
