"""SelectedRows: the sparse {row ids, row values} gradient carrier.

A copy of paddle_tpu/sparse/selected_rows.py (numpy only; the port
imports nothing of the JAX package).  The gradient of an embedding
lookup touches only the looked-up rows, so it can travel as a (rows,
values) pair instead of a dense ``[vocab, dim]`` tensor (ref
framework/selected_rows.h and the merge_selected_rows family); it is
the input of the host-side table update (sparse/table.py).

The one semantic trap of the representation, and the reason
``merged()`` exists, is duplicate ids: a batch that looks up row 7
twice must contribute BOTH cotangents to row 7 (scatter-ADD), not let
the second overwrite the first.  ``merged()`` canonicalizes to unique,
sorted rows with summed values.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["SelectedRows"]


class SelectedRows:
    """rows: [N] int64 global row ids; values: [N, dim] float32.

    ``height`` is the full table's row count (the dense shape this
    sparse view projects into) — kept for bounds checks and
    ``to_dense``, exactly the reference's ``SelectedRows::height_``."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows: Sequence[int], values, height: int):
        self.rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        self.values = np.asarray(values, dtype=np.float32)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        if self.values.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"SelectedRows: {self.rows.shape[0]} rows but "
                f"{self.values.shape[0]} value rows")
        self.height = int(height)
        if self.rows.size and (self.rows.min() < 0
                               or self.rows.max() >= self.height):
            raise ValueError(
                f"SelectedRows: row ids outside [0, {self.height}): "
                f"min={self.rows.min()}, max={self.rows.max()}")

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def merged(self) -> "SelectedRows":
        """Canonical form: unique sorted rows, duplicate ids' values
        SUMMED (the scatter-add contract; ref merge_selected_rows_op).
        Idempotent; returns self when already canonical."""
        if self.rows.size == 0:
            return self
        uniq, inv = np.unique(self.rows, return_inverse=True)
        if uniq.shape[0] == self.rows.shape[0] \
                and np.array_equal(uniq, self.rows):
            return self
        out = np.zeros((uniq.shape[0], self.values.shape[1]),
                       dtype=np.float32)
        np.add.at(out, inv, self.values)
        return SelectedRows(uniq, out, self.height)

    def to_dense(self) -> np.ndarray:
        """Materialize the dense [height, dim] view (tests/debug only —
        production paths must never call this; the whole point of the
        representation is that they don't have to)."""
        out = np.zeros((self.height, self.values.shape[1]), np.float32)
        np.add.at(out, self.rows, self.values)
        return out

    @staticmethod
    def from_dense(grad: np.ndarray, rows=None) -> "SelectedRows":
        """Extract the nonzero (or explicitly named) rows of a dense
        gradient — the test-side bridge from a dense-reference run to
        the sparse wire format."""
        grad = np.asarray(grad, np.float32)
        if rows is None:
            rows = np.nonzero(np.abs(grad).sum(axis=1))[0]
        rows = np.asarray(rows, np.int64)
        return SelectedRows(rows, grad[rows], grad.shape[0])

    def to_wire(self) -> dict:
        """The JSON payload of a sparse gradient push."""
        return {"rows": self.rows.tolist(),
                "values": self.values.tolist(),
                "height": self.height}

    @staticmethod
    def from_wire(doc: dict) -> "SelectedRows":
        return SelectedRows(doc["rows"], np.asarray(doc["values"],
                                                    np.float32),
                            doc["height"])

    def __repr__(self):
        return (f"SelectedRows(n={len(self)}, dim={self.dim}, "
                f"height={self.height})")
