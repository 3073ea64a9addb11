"""Layers package (counterpart of paddle_tpu/layers/)."""
from . import control_flow, nn, rnn, sequence, tensor  # noqa: F401
from .nn import *  # noqa: F401,F403
from .sequence import (beam_search, beam_search_decode,  # noqa: F401
                       crf_decoding, linear_chain_crf, sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_pool, sum)
from .rnn import (dynamic_gru, dynamic_lstm, gru_unit,  # noqa: F401
                  lstm_layer, lstm_unit)
from .tensor import (assign, cast, concat,  # noqa: F401
                     fill_constant_batch_size_like, sums)
from .control_flow import StaticRNN  # noqa: F401
