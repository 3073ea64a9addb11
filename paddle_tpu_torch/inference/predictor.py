"""Predictor: inference over a saved program.

Counterpart of paddle_tpu/inference/predictor.py (the reference's
AnalysisPredictor tier: NativeConfig, AnalysisConfig, Predictor,
create_predictor).  The JAX predictor compiles the program ahead of time
per input signature; here the program's ops run eagerly, so ``prepare``
validates the feeds and runs once as a warm-up (the first CUDA launch
builds and loads the kernel library), and there is nothing to compile.

A config asks for the GPU by default (``use_gpu=True``) and raises when
there is none: it never serves silently on the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import io as pio
from ..core.enforce import check_arg
from ..core.place import CPUPlace, CUDAPlace
from ..framework.executor import (Executor, Scope, as_tensor,
                                  run_ops_in_env, to_numpy)
from ..framework.registry import LowerContext


class NativeConfig:
    def __init__(self, model_dir: Optional[str] = None,
                 use_gpu: bool = True, device: int = 0):
        self.model_dir = model_dir
        self.use_gpu = use_gpu
        self.device = device


class AnalysisConfig(NativeConfig):
    """The reference's analysis config.  Its graph-fusion switches have no
    counterpart here: the kernels are chosen by device, not by pass."""


class Predictor:
    """Executor-free inference runner over a pruned program."""

    def __init__(self, config: NativeConfig, _shared=None):
        self.config = config
        if _shared is not None:
            (self.program, self.feed_names, self.fetch_names,
             self.state, self._device) = _shared
            self._ops = self.program.global_block().ops
            return
        check_arg(config.model_dir is not None
                  and os.path.isdir(config.model_dir),
                  f"model_dir {config.model_dir!r} does not exist")
        place = CUDAPlace(config.device) if config.use_gpu else CPUPlace()
        # raises without a card: a config asking for the GPU must not
        # silently serve on the CPU
        self._device = place.torch_device()
        scope = Scope()
        exe = Executor(place, scope=scope)
        self.program, self.feed_names, self.fetch_names = \
            pio.load_inference_model(config.model_dir, exe)
        persist = {v.name for v in self.program.list_vars() if v.persistable}
        self.state = {n: scope.find_var(n) for n in persist
                      if scope.find_var(n) is not None}
        self._ops = self.program.global_block().ops

    def _check_feed_names(self, feeds: Dict[str, object]):
        """Both directions: a missing feed can't run, and an unknown feed
        is a caller's mistake that must not pass silently."""
        missing = set(self.feed_names) - set(feeds)
        check_arg(not missing, f"missing feeds: {sorted(missing)}")
        unknown = set(feeds) - set(self.feed_names)
        check_arg(not unknown,
                  f"unknown feed names {sorted(unknown)}: this predictor "
                  f"feeds {sorted(self.feed_names)}")

    def run(self, feeds: Dict[str, object],
            return_numpy: bool = True) -> List:
        self._check_feed_names(feeds)
        block = self.program.global_block()
        with torch.inference_mode():
            env = dict(self.state)
            for n, v in feeds.items():
                env[n] = as_tensor(v, block.var(n) if block.has_var(n)
                                   else None, self._device)
            ctx = LowerContext(0, self._device, self.program)
            env = run_ops_in_env(ctx, env, self._ops)
            outs = [env[n] for n in self.fetch_names]
        if return_numpy:
            return [to_numpy(o) for o in outs]
        return outs

    __call__ = run

    def prepare(self, example_feeds: Dict[str, object]):
        """Validate the feeds and run once as a warm-up (builds and loads
        the kernel library on the first CUDA run)."""
        self.run(example_feeds, return_numpy=False)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def prepare_buckets(self, example_feeds: Dict[str, np.ndarray],
                        batch_sizes: Sequence[int],
                        seq_lens: Optional[Sequence[int]] = None) -> dict:
        """Warm every (batch, seq) combination of `batch_sizes` x
        `seq_lens`: `example_feeds` supplies dtypes and trailing shapes;
        axis 0 is resized to each batch size and (for feeds with >= 2
        dims) axis 1 to each sequence length.  Returns
        {"(batch, seq)": seconds} + totals."""
        feeds0 = {n: np.asarray(v) for n, v in example_feeds.items()}
        self._check_feed_names(feeds0)
        report: Dict[str, float] = {}
        t0 = time.perf_counter()
        for bs in batch_sizes:
            for sl in (seq_lens if seq_lens else [None]):
                feeds = {}
                for n, a in feeds0.items():
                    shape = list(a.shape)
                    if shape:
                        shape[0] = int(bs)
                    if sl is not None and a.ndim >= 2:
                        shape[1] = int(sl)
                    feeds[n] = np.zeros(shape, a.dtype)
                tb = time.perf_counter()
                self.prepare(feeds)
                report[f"({bs}, {sl})"] = time.perf_counter() - tb
        report["total_seconds"] = time.perf_counter() - t0
        report["buckets"] = len(report) - 1
        return report

    def clone(self) -> "Predictor":
        """Share program and parameter tensors (inference never writes
        them, so sharing between threads is safe)."""
        return Predictor(self.config, _shared=(
            self.program, self.feed_names, self.fetch_names, self.state,
            self._device))

    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)


def create_predictor(config: NativeConfig) -> Predictor:
    """ref CreatePaddlePredictor (paddle_api.h)."""
    return Predictor(config)
