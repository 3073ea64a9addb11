"""Op lowerings: importing this package registers every ported op."""
from . import (activation, attention_ops, creation, elementwise,  # noqa: F401
               fused_ops, loss_ops, math_ops, metric_ops, misc_ops,
               nn_ops, optimizer_ops, reduce_ops, rnn_ops, structural,
               tensor_manip)
