"""Op lowerings: importing this package registers every ported op."""
from . import (activation, attention_ops, creation, elementwise,  # noqa: F401
               loss_ops, math_ops, nn_ops, optimizer_ops, structural,
               tensor_manip)
