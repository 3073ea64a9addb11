"""Models (counterpart of paddle_tpu/models)."""
from . import bert, deepfm, lenet, resnet, transformer, vgg  # noqa: F401
