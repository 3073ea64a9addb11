"""Unique name generator (a copy of paddle_tpu/framework/unique_name.py).

Parameter names come out of these counters, so they must advance exactly
as the JAX package's do: a model dir saved there binds by name here.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

_counters = defaultdict(int)


def generate(key: str) -> str:
    _counters[key] += 1
    return f"{key}_{_counters[key] - 1}"


def reset():
    _counters.clear()


@contextlib.contextmanager
def guard():
    """A fresh namespace for the block: the Trainer builds in one, so a
    Trainer built again names its parameters alike."""
    global _counters
    saved = _counters
    _counters = defaultdict(int)
    try:
        yield
    finally:
        _counters = saved
