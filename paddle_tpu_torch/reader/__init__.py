"""Reader pipeline (counterpart of paddle_tpu/reader/, the reference's
python/paddle/reader/)."""
from .decorator import (THREAD_PREFIX, DeviceBatch, PipeReader, batch,
                        buffered, cache, chain, compose, device_prefetch,
                        elastic_shard, elastic_watermark, firstn,
                        map_readers, shuffle)
