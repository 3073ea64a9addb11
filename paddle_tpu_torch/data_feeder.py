"""DataFeeder: reader minibatch rows -> feed dict of dense numpy arrays.

A copy of paddle_tpu/data_feeder.py, which is framework-neutral numpy:
the reference's DataFeeder.feed batches rows into LoDTensors; here there
is no LoD — variable-length fields are padded to the batch max (or a
fixed `pad_to`) with an optional companion `<name>_mask` float array,
the dense/segment-mask story the models consume.  The executor uploads
the arrays (or reader.device_prefetch does, ahead of the step).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.dtypes import convert_dtype
from .framework.program import Variable


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None,
                 pad_to: Optional[Dict[str, int]] = None,
                 emit_masks: bool = False):
        self.feed_vars: List[Variable] = list(feed_list)
        self.pad_to = dict(pad_to or {})
        self.emit_masks = emit_masks

    def feed(self, minibatch: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        """minibatch: list of rows, each row one value per feed var."""
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in minibatch]
            dtype = convert_dtype(var.dtype)
            first = np.asarray(col[0])
            is_ragged = any(np.asarray(c).shape != first.shape for c in col)
            if is_ragged or var.name in self.pad_to:
                arrs = [np.atleast_1d(np.asarray(c)) for c in col]
                maxlen = self.pad_to.get(
                    var.name, max(a.shape[0] for a in arrs))
                tail = arrs[0].shape[1:]
                batch = np.zeros((len(arrs), maxlen) + tail, dtype=dtype)
                mask = np.zeros((len(arrs), maxlen), dtype="float32")
                for j, a in enumerate(arrs):
                    n = min(a.shape[0], maxlen)
                    batch[j, :n] = a[:n]
                    mask[j, :n] = 1.0
                out[var.name] = batch
                if self.emit_masks:
                    out[var.name + "_mask"] = mask
            else:
                batch = np.asarray(col).astype(dtype)
                # reference feeds scalars as [N, 1] (labels)
                want_rank = len(var.shape) if var.shape else None
                if want_rank is not None and batch.ndim < want_rank:
                    batch = batch.reshape(batch.shape + (1,) * (
                        want_rank - batch.ndim))
                out[var.name] = batch
        return out
