"""Host-plane sparse embedding tables: hash buckets, row-wise adagrad,
optional int8 row storage.

A copy of paddle_tpu/sparse/table.py (numpy only; the port imports
nothing of the JAX package).  Capability parity with the reference's
pserver big-table stack: the table and its optimizer state live on the
host and are updated from sparse gradients (SelectedRows); the adagrad
accumulator is split row-aligned with the table shard
(distribute_transpiler.py:1010), so a sparse update touches the same
rows of both; ids far beyond any dense vocab fold into a fixed bucket
count before lookup (``hash_bucket``), by the same avalanche as the
in-graph ``sparse_embedding_lookup`` op (ops/nn_ops.py).

int8 row storage is row-wise symmetric abs-max (scale = rowmax / 127):
each row stores int8 codes and one f32 scale; pulls dequantize, applies
requantize only the touched rows.  Adagrad accumulators stay f32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .selected_rows import SelectedRows

__all__ = ["TableConfig", "EmbeddingShard", "hash_bucket",
           "partition_rows", "HASH_MIX"]

# xor-shift/multiply avalanche constant (lowbias32 family).  A bare
# Knuth multiply is the identity mod small powers of two, so
# power-of-two bucket counts would never mix; the xor-shifts spread high
# bits into the low ones.  The SAME sequence is implemented by the
# sparse_embedding_lookup op (ops/nn_ops.py) so host bucketing and
# in-graph bucketing agree on every id.
HASH_MIX = np.uint32(0x45D9F3B)


def hash_bucket(ids, num_buckets: int) -> np.ndarray:
    """Fold arbitrary (possibly > vocab) non-negative ids into
    [0, num_buckets) — the reference CTR pipelines' id folding,
    deterministic across host and device."""
    with np.errstate(over="ignore"):
        x = np.asarray(ids, np.uint64).astype(np.uint32)
        x ^= x >> np.uint32(16)
        x *= HASH_MIX
        x ^= x >> np.uint32(16)
        x *= HASH_MIX
        x ^= x >> np.uint32(16)
    return (x % np.uint32(num_buckets)).astype(np.int64)


def partition_rows(rows: np.ndarray, num_shards: int
                   ) -> Dict[int, np.ndarray]:
    """Mod-partition global row ids across shard owners: shard s owns
    rows where ``row % num_shards == s`` (the transpiler's round-robin
    split of the distributed lookup table).  Returns {shard: rows}."""
    rows = np.asarray(rows, np.int64)
    return {s: rows[rows % num_shards == s] for s in range(num_shards)
            if ((rows % num_shards) == s).any()}


@dataclass
class TableConfig:
    """One sparse table's spec (shape, seed, optimizer), with its JSON
    form (``to_wire`` / ``from_wire``)."""

    name: str
    rows: int
    dim: int
    seed: int = 0
    init_std: float = 0.01          # 0.0 = zero-init (bias-like tables)
    learning_rate: float = 0.1
    optimizer: str = "sgd"          # "sgd" | "adagrad"
    adagrad_eps: float = 1e-6
    int8_rows: bool = False

    def to_wire(self) -> dict:
        return {k: getattr(self, k) for k in
                ("name", "rows", "dim", "seed", "init_std",
                 "learning_rate", "optimizer", "adagrad_eps",
                 "int8_rows")}

    @staticmethod
    def from_wire(doc: dict) -> "TableConfig":
        return TableConfig(**doc)


def _init_dense(cfg: TableConfig) -> np.ndarray:
    """Seeded full-table init: two shards of one config start from the
    same weights."""
    if cfg.init_std == 0.0:
        return np.zeros((cfg.rows, cfg.dim), np.float32)
    rng = np.random.RandomState(cfg.seed)
    return (rng.randn(cfg.rows, cfg.dim) * cfg.init_std).astype(
        np.float32)


class EmbeddingShard:
    """The rows of one table owned by one shard.

    ``shard_id``/``num_shards`` select the mod-partition this shard
    holds (global row r lives at local index r // num_shards on shard
    r % num_shards); the single-service case is shard 0 of 1 holding
    everything.  All mutation goes through :meth:`apply` with a
    SelectedRows gradient — there is no dense-update path at all.
    """

    def __init__(self, cfg: TableConfig, shard_id: int = 0,
                 num_shards: int = 1):
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.cfg = cfg
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        full = _init_dense(cfg)
        local = full[shard_id::num_shards]
        self.local_rows = local.shape[0]
        if cfg.int8_rows:
            self._codes, self._scales = _quantize_rows(local)
            self._table = None
        else:
            self._table = local.copy()
            self._codes = self._scales = None
        # adagrad accumulator, row-aligned with the shard (f32 always)
        self._accum = (np.zeros_like(local)
                       if cfg.optimizer == "adagrad" else None)
        self.version = 0            # bumps once per applied push
        self.rows_pulled = 0
        self.rows_pushed = 0
        # construction-time registration: the memscope census files
        # state_bytes() as the host-side sparse_tables plane
        from ..observability import memscope as obs_memscope
        obs_memscope.register_sparse_shard(self)

    # -- local/global row mapping ------------------------------------------
    def _local(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        if rows.size:
            if (rows < 0).any() or (rows >= self.cfg.rows).any():
                raise ValueError(
                    f"table {self.cfg.name!r}: row ids outside "
                    f"[0, {self.cfg.rows})")
            if (rows % self.num_shards != self.shard_id).any():
                raise ValueError(
                    f"table {self.cfg.name!r}: rows not owned by shard "
                    f"{self.shard_id}/{self.num_shards}")
        return rows // self.num_shards

    # -- read --------------------------------------------------------------
    def pull(self, rows) -> np.ndarray:
        """[N] global row ids -> [N, dim] f32 rows (dequantized when
        the table stores int8)."""
        loc = self._local(rows)
        self.rows_pulled += int(loc.size)
        if self._table is not None:
            return self._table[loc].copy()
        return (self._codes[loc].astype(np.float32)
                * self._scales[loc][:, None])

    def dense(self) -> np.ndarray:
        """This shard's full [local_rows, dim] view — eval/tests only."""
        if self._table is not None:
            return self._table.copy()
        return self._codes.astype(np.float32) * self._scales[:, None]

    # -- sparse update -----------------------------------------------------
    def apply(self, grad: SelectedRows) -> int:
        """Scatter-apply one SelectedRows gradient: merge duplicates,
        update ONLY the touched rows (table + accumulator), bump the
        version.  Returns the number of distinct rows applied."""
        if grad.height != self.cfg.rows:
            raise ValueError(
                f"table {self.cfg.name!r}: grad height {grad.height} "
                f"!= table rows {self.cfg.rows}")
        g = grad.merged()
        loc = self._local(g.rows)
        gv = g.values
        lr = self.cfg.learning_rate
        rows_f32 = (self._table[loc] if self._table is not None
                    else self._codes[loc].astype(np.float32)
                    * self._scales[loc][:, None])
        if self._accum is not None:
            self._accum[loc] += gv * gv
            denom = np.sqrt(self._accum[loc]) + self.cfg.adagrad_eps
            rows_f32 = rows_f32 - lr * gv / denom
        else:
            rows_f32 = rows_f32 - lr * gv
        if self._table is not None:
            self._table[loc] = rows_f32
        else:
            codes, scales = _quantize_rows(rows_f32)
            self._codes[loc] = codes
            self._scales[loc] = scales
        self.version += 1
        self.rows_pushed += int(loc.size)
        return int(loc.size)

    # -- snapshot ----------------------------------------------------------
    def state_view(self) -> dict:
        """A cheap copied view of this shard's mutable state (numpy
        copies; ``state_doc`` serializes it)."""
        v = {"cfg": self.cfg.to_wire(), "shard_id": self.shard_id,
             "num_shards": self.num_shards, "version": self.version,
             "rows_pulled": self.rows_pulled,
             "rows_pushed": self.rows_pushed}
        if self._table is not None:
            v["table"] = self._table.copy()
        else:
            v["codes"] = self._codes.copy()
            v["scales"] = self._scales.copy()
        if self._accum is not None:
            v["accum"] = self._accum.copy()
        return v

    def state_doc(self) -> dict:
        """JSON-able full state of this shard (values/codes, adagrad
        accumulator, version, counters); ``from_state`` restores it."""
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in self.state_view().items()}

    @classmethod
    def from_state(cls, doc: dict) -> "EmbeddingShard":
        t = cls(TableConfig.from_wire(doc["cfg"]),
                int(doc["shard_id"]), int(doc["num_shards"]))
        if "table" in doc:
            t._table = np.asarray(doc["table"], np.float32)
        else:
            t._codes = np.asarray(doc["codes"], np.int8)
            t._scales = np.asarray(doc["scales"], np.float32)
        if "accum" in doc:
            t._accum = np.asarray(doc["accum"], np.float32)
        t.version = int(doc["version"])
        t.rows_pulled = int(doc.get("rows_pulled", 0))
        t.rows_pushed = int(doc.get("rows_pushed", 0))
        return t

    def state_bytes(self) -> int:
        if self._table is not None:
            n = self._table.nbytes
        else:
            n = self._codes.nbytes + self._scales.nbytes
        if self._accum is not None:
            n += self._accum.nbytes
        return n


def _quantize_rows(rows_f32: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise symmetric int8: codes [N, D] int8 + scale [N] f32
    (abs-max / 127)."""
    absmax = np.abs(rows_f32).max(axis=1)
    scales = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.rint(rows_f32 / scales[:, None]),
                    -127, 127).astype(np.int8)
    return codes, scales
