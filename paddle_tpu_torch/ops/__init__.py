"""Op lowerings: importing this package registers every ported op."""
from . import (activation, attention_ops, beam_search_ops,  # noqa: F401
               control_flow, creation, crf_ops, elementwise, fused_ops,
               loss_ops, math_ops, metric_ops, misc_ops, nn_ops,
               optimizer_ops, quantize_ops, reduce_ops, rnn_ops,
               sampling_ops, sequence_ops, structural, tensor_manip)
