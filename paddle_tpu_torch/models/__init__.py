"""Models (counterpart of paddle_tpu/models)."""
from . import (alexnet, bert, book, deepfm, googlenet,  # noqa: F401
               lenet, machine_translation, resnet, se_resnext,
               stacked_lstm, transformer, vgg)
