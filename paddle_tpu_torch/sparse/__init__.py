"""The sparse plane's host-side modules (counterpart of
paddle_tpu/sparse/: ``selected_rows`` and ``table``, copied).

  * :mod:`selected_rows` — the {rows, values} sparse-gradient carrier;
    duplicate ids merge by ADDITION.
  * :mod:`table` — hash-bucketed host tables with row-wise adagrad
    state and optional int8 row storage.

The in-graph side is ops/nn_ops.py's ``sparse_embedding_lookup`` (hash
bucketing by the same avalanche as :func:`hash_bucket`) and
``sparse_scatter_update``.  The streaming sparse trainer (the shard
service, the worker, the async update client) is not ported (ROADMAP
queue A.8).
"""
from .selected_rows import SelectedRows
from .table import (EmbeddingShard, TableConfig, hash_bucket,
                    partition_rows)

__all__ = ["SelectedRows", "EmbeddingShard", "TableConfig",
           "hash_bucket", "partition_rows"]
