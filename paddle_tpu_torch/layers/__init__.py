"""Layers package (counterpart of paddle_tpu/layers/).  Importing it
patches Variable's operators (math_op_patch), as the JAX package's
layers/__init__.py does."""
from . import (control_flow, learning_rate_scheduler, nn, rnn,  # noqa: F401
               sequence, tensor)
from .nn import *  # noqa: F401,F403
from .sequence import (adaptive_pool3d, autoincreased_step_counter,  # noqa: F401
                       beam_search, beam_search_decode,
                       bilinear_tensor_product, bpr_loss, conv3d,
                       conv3d_transpose, crf_decoding, crop, dice_loss,
                       edit_distance, gaussian_random_batch_size_like,
                       image_resize_short, linear_chain_crf, log_loss,
                       margin_rank_loss, mean_iou, multiplex,
                       pad_constant_like, pool3d, rank_loss, sampling_id,
                       sequence_conv, sequence_first_step,
                       sequence_last_step, sequence_pool, shape,
                       space_to_depth, sum)
from .rnn import (dynamic_gru, dynamic_lstm, gru_unit,  # noqa: F401
                  lstm_layer, lstm_unit)
from .tensor import (argmax, argmin, argsort, assign,  # noqa: F401
                     cast, concat, create_tensor, diag, eye, fill_constant,
                     fill_constant_batch_size_like, linspace, ones,
                     ones_like, reverse, sums, zeros, zeros_like)
from .control_flow import StaticRNN, Switch, While  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
