"""Models (counterpart of paddle_tpu/models)."""
from . import (alexnet, bert, deepfm, googlenet, lenet,  # noqa: F401
               resnet, se_resnext, stacked_lstm, transformer, vgg)
