"""Layers package (counterpart of paddle_tpu/layers/).  Importing it
patches Variable's operators (math_op_patch), as the JAX package's
layers/__init__.py does."""
from . import (control_flow, learning_rate_scheduler, nn, rnn,  # noqa: F401
               sequence, tensor)
from .nn import *  # noqa: F401,F403
from .sequence import (  # noqa: F401
    sequence_conv, sequence_context, sequence_pool, scale_sub_region,
    sequence_first_step, sequence_last_step, sequence_softmax,
    sequence_concat, sequence_slice, sequence_expand, sequence_expand_as,
    sequence_pad, sequence_unpad, sequence_reshape, sequence_enumerate,
    sequence_scatter, sequence_reverse, lod_reset, linear_chain_crf,
    crf_decoding, chunk_eval, warpctc, ctc_greedy_decoder, edit_distance,
    nce, hsigmoid, sampling_id, beam_search, beam_search_decode, conv3d,
    conv3d_transpose, pool3d, adaptive_pool3d, im2sequence, grid_sampler,
    affine_channel, space_to_depth, crop, pad_constant_like,
    image_resize_short, random_crop, bpr_loss, rank_loss, margin_rank_loss,
    log_loss, dice_loss, mean_iou, multiplex, row_conv,
    bilinear_tensor_product, add_position_encoding, similarity_focus, hash,
    merge_selected_rows, get_tensor_from_selected_rows, shape, sum,
    gaussian_random_batch_size_like, autoincreased_step_counter, lstm,
    dynamic_lstmp)
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
