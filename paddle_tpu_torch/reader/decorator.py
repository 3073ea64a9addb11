"""Composable reader decorators.

A copy of paddle_tpu/reader/decorator.py's framework-neutral decorators
(the reference's python/paddle/reader/decorator.py map_readers:36,
shuffle:58, chain:93, compose:125, buffered:172, PipeReader:438 and
python/paddle/batch.py), with ``device_prefetch`` re-expressed in torch:
its one JAX touchpoint was ``jax.device_put``.  A *reader* is a zero-arg
callable returning an iterator of samples; a *reader creator* builds
readers.  ``xmap_readers`` and ``multiprocess_reader`` are not ported
(ROADMAP queue A.5).
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import subprocess
import threading

from ..observability import metrics as obs_metrics

# input-pipeline headroom: sampled at every buffered() consume.  Depth
# pinned at 0 while the device waits = the producer can't keep up
# (pairs with the trainer's trainer_data_wait_seconds anatomy).
# Labeled per buffered() so composed pipelines — e.g.
# buffered(batch(buffered(raw, 64)), 8) — stay attributable instead of
# two queues racing one series.
_m_buffer_depth = obs_metrics.gauge(
    "reader_buffer_depth",
    "Items queued in a reader.buffered() prefetch queue at its last "
    "consume, labeled per buffered() decorator (name= arg, or "
    "buffered<N> in creation order).",
    ("reader",))
_buffered_seq = itertools.count()
# anonymous buffered() labels recycle modulo this bound: a pipeline
# rebuilt every epoch must not grow one permanent gauge series per
# epoch (registry series are never reclaimed).  Pass name= for stable
# attribution.
_MAX_ANON_BUFFERED_LABELS = 64
# the name prefix of this module's producer threads, which tells them
# from other libraries' (the JAX package's are "Thread-N (producer)")
THREAD_PREFIX = "ptt-reader-"

__all__ = ["map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "batch", "cache", "PipeReader", "DeviceBatch",
           "device_prefetch", "elastic_shard", "elastic_watermark"]


def elastic_shard(reader, world: int, rank: int, start: int = 0):
    """Partition one GLOBAL example stream across an elastic fleet:
    fast-forward past the first ``start`` examples (the
    watermark everything already consumed before a resize), then yield
    the round-robin share of the remainder — global index ``i`` goes to
    ``(i - start) % world == rank``.

    The elastic-resize discipline: resizes land at epoch (or other
    all-ranks-agree) boundaries, where every rank has consumed the same
    number of ROUNDS ``r`` — so the fleet-wide watermark is
    ``start + r * world``.  Re-partitioning the stream from that
    watermark under a new world size hands every remaining example to
    exactly one rank and repeats none: N→M resizes drop nothing and
    double-consume nothing (tests/test_torch_trainer.py holds it).

    A checkpoint records the watermark, not per-rank offsets: compute
    it with the companion :func:`elastic_watermark` from the per-rank
    rounds consumed."""
    world, rank, start = int(world), int(rank), int(start)
    if not (0 <= rank < world):
        raise ValueError(f"elastic_shard: rank {rank} outside world "
                         f"{world}")
    if start < 0:
        raise ValueError(f"elastic_shard: negative start {start}")

    def data_reader():
        for i, item in enumerate(reader()):
            if i < start:
                continue                       # fast-forward
            if (i - start) % world == rank:
                yield item
    return data_reader


def elastic_watermark(start: int, rounds: int, world: int) -> int:
    """The global consumed-through watermark after ``rounds`` per-rank
    items under ``world`` ranks from ``start`` — the value to feed the
    next :func:`elastic_shard` as its ``start`` after a resize at a
    rank-aligned boundary."""
    return int(start) + int(rounds) * int(world)


class DeviceBatch:
    """One prefetched step's feed, already staged on the DEVICE by
    ``device_prefetch``: ``feed`` is a {name: torch.Tensor} dict ready to
    hand to Executor.run, ``size`` the raw batch size (the trainer's
    examples/s denominator).  The consumer must treat the buffers as
    single-use."""

    __slots__ = ("feed", "size")

    def __init__(self, feed, size):
        self.feed = feed
        self.size = size


def device_prefetch(reader, size: int = 2, feeder=None, device=None,
                    name: str = "device_prefetch"):
    """Async DEVICE prefetch: a background thread builds each step's
    feed (via ``feeder.feed`` when given, else the reader must yield
    {name: array} dicts) and stages it on `device` (default: the card,
    ``core.place.default_place()``) while the consumer's CURRENT step
    runs — the double-buffered input pipeline (size=2) that takes the
    reader wait AND the host->device copy out of the training step.

    On a CUDA device the thread copies each array from pinned host
    memory on a side stream and records an event; the consumer's
    current stream waits on that event before the batch is yielded, and
    each tensor is recorded on that stream for the caching allocator.
    On the CPU the thread builds the tensors and no stream is involved.

    Yields DeviceBatch items; queue depth rides the
    ``reader_buffer_depth`` gauge under `name`.  Producer exceptions
    re-raise in the consumer.  The thread ends with the iteration: when
    the consumer stops early (``close()`` on the iterator, or the
    iterator dropped), the producer is told to stop and is joined.
    """
    import numpy as np
    import torch

    from ..core.place import default_place

    device = torch.device(device) if device is not None else \
        default_place().torch_device()
    cuda = device.type == "cuda"
    depth_gauge = _m_buffer_depth.labels(reader=name)

    class _End:
        pass

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def _host(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))

    def _stage(batch, stream):
        if feeder is not None:
            feed = feeder.feed(batch)
            n = len(batch)
        else:
            if not isinstance(batch, dict):
                raise TypeError(
                    "device_prefetch without a feeder needs the reader "
                    "to yield {name: array} feed dicts; got "
                    f"{type(batch).__name__}")
            feed = batch
            first = next(iter(batch.values()))
            n = int(getattr(first, "shape", (1,))[0] or 1)
        if not cuda:
            return DeviceBatch({k: _host(v).to(device)
                                for k, v in feed.items()}, n), None
        with torch.cuda.stream(stream):
            staged = {k: _host(v).pin_memory().to(device, non_blocking=True)
                      for k, v in feed.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return DeviceBatch(staged, n), ready

    def data_reader():
        q: queue.Queue = queue.Queue(maxsize=max(1, int(size)))
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                stream = torch.cuda.Stream(device) if cuda else None
                for d in reader():
                    if not put(_stage(d, stream)):
                        return
            except BaseException as exc:   # propagate to consumer
                put(_Error(exc))
            else:
                put(_End)

        t = threading.Thread(target=producer, daemon=True,
                             name=f"{THREAD_PREFIX}device_prefetch")
        t.start()
        try:
            while True:
                e = q.get()
                depth_gauge.set(q.qsize())
                if e is _End:
                    break
                if isinstance(e, _Error):
                    raise e.exc
                batch, ready = e
                if ready is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(ready)
                    for v in batch.feed.values():
                        v.record_stream(current)
                yield batch
        finally:
            stop.set()
            t.join()
    return data_reader


def map_readers(func, *readers):
    """Apply func to the items of several readers zipped together."""
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Pool-shuffle within a sliding buffer (ref decorator.py:58)."""
    def data_reader():
        rng = _random.Random(seed)
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf
    return data_reader


def chain(*readers):
    """Concatenate readers back to back (ref decorator.py:93)."""
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, check_alignment: bool = True):
    """Zip readers into tuple samples (ref decorator.py:125)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iters = itertools.zip_longest(*rs) if not check_alignment else zip(*rs)
        for outputs in iters:
            if check_alignment and any(o is None for o in outputs):
                raise RuntimeError("readers not aligned")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def buffered(reader, size: int, name: str = None):
    """Background-thread prefetch into a bounded queue (ref :172) —
    overlaps host input work with device steps.  Producer exceptions are
    re-raised in the consumer (not swallowed as end-of-data).  `name`
    labels this queue's reader_buffer_depth gauge series (auto
    buffered<N> otherwise)."""
    depth_gauge = _m_buffer_depth.labels(
        reader=name or "buffered%d" % (
            next(_buffered_seq) % _MAX_ANON_BUFFERED_LABELS))

    class _End:
        pass

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def data_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def producer():
            try:
                for d in reader():
                    q.put(d)
            except BaseException as exc:   # propagate to consumer
                q.put(_Error(exc))
            else:
                q.put(_End)

        t = threading.Thread(target=producer, daemon=True,
                             name=f"{THREAD_PREFIX}buffered")
        t.start()
        while True:
            e = q.get()
            depth_gauge.set(q.qsize())
            if e is _End:
                break
            if isinstance(e, _Error):
                raise e.exc
            yield e
    return data_reader


def firstn(reader, n: int):
    """The first n items of a reader."""
    def data_reader():
        return itertools.islice(reader(), n)
    return data_reader


def cache(reader):
    """Materialise once, then replay from memory.  A failed first pass
    leaves nothing cached (no partial/duplicated data on retry)."""
    state = {"data": None}

    def data_reader():
        if state["data"] is None:
            state["data"] = list(reader())   # atomic: assign only on success
        return iter(state["data"])
    return data_reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists of batch_size (ref python/paddle/batch.py)."""
    def batch_reader():
        b = []
        for d in reader():
            b.append(d)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


class PipeReader:
    """Stream records from a shell command's stdout (ref decorator.py:438)."""

    def __init__(self, command: str, bufsize: int = 8192):
        self.command = command
        self.bufsize = bufsize

    def get_line(self, cut_lines: bool = True, line_break: bytes = b"\n"):
        proc = subprocess.Popen(self.command.split(),
                                stdout=subprocess.PIPE, bufsize=self.bufsize)
        remained = b""
        assert proc.stdout is not None
        while True:
            buf = proc.stdout.read(self.bufsize)
            if not buf:
                break
            if cut_lines:
                lines = (remained + buf).split(line_break)
                remained = lines.pop(-1)
                yield from lines
            else:
                yield buf
        if remained:
            yield remained
