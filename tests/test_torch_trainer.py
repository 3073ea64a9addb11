"""The port's Trainer, DataFeeder, reader decorators and numeric guard,
against the JAX package's.

The Trainer of both packages trains a tiny LM (V 256, L 2, H 4, d_model
64, d_inner 128, T 32, batch 2, dropout 0, the fused attention build
with the streamed head; Adam 1e-3) for one epoch of 4 batches from one
``param_path`` that the JAX Trainer saved: the ``EndStepEvent`` losses
at rtol 1e-5 and the events in the same order, plain and with
``accumulate_steps`` 2 and ``prefetch_depth`` 2.  The rest mirrors the
JAX package's ``tests/test_reader_trainer.py`` (:14, :40, :80, :237,
:337) in the port.
"""
import os
import signal
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import reader
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience import guard as rguard

T, BATCH, N_BATCH, LR = 32, 2, 4, 1e-3
FEEDS = ["tokens", "labels"]


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


def lm_train_func(tr):
    def train_func():
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr), T, fused_attention=True,
                                     fused_head=True)
        return loss
    return train_func


def lm_reader(n=N_BATCH, seed=600):
    def r():
        for i in range(n):
            b = ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T,
                                       seed=seed + i)
            yield [(b["tokens"][j], b["labels"][j]) for j in range(BATCH)]
    return r


def recorder(events):
    def handler(e):
        metrics = [np.asarray(m) for m in getattr(e, "metrics", [])]
        events.append((type(e).__name__, getattr(e, "epoch", None),
                       getattr(e, "step", None), metrics))
    return handler


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    chaos.reset()
    yield
    ptt.flags.set_flag("chaos_spec", "")
    ptt.flags.set_flag("nan_policy", "raise")
    chaos.reset()
    ptt.reset_default_programs()


@pytest.mark.parametrize("k,prefetch", [(1, 0), (2, 2)],
                         ids=["plain", "accumulate2_prefetch2"])
def test_trainer_matches_the_jax_trainer(tmp_path, k, prefetch):
    jt = pt.Trainer(lm_train_func(jtr), lambda: pt.optimizer.Adam(LR),
                    place=pt.CPUPlace(), accumulate_steps=k)
    jt.save_params(str(tmp_path))
    jev = []
    jt.train(1, recorder(jev), lm_reader(), FEEDS, prefetch_depth=prefetch)

    tt = ptt.Trainer(lm_train_func(ttr), lambda: ptt.optimizer.Adam(LR),
                     place=ptt.CPUPlace(), accumulate_steps=k,
                     param_path=str(tmp_path))
    tev = []
    tt.train(1, recorder(tev), lm_reader(), FEEDS, prefetch_depth=prefetch)
    tt.stop()
    assert [e[:3] for e in tev] == [e[:3] for e in jev]
    assert [e[0] for e in tev] == (["BeginEpochEvent"] + [
        "BeginStepEvent", "EndStepEvent"] * N_BATCH + ["EndEpochEvent"])
    losses = [(t[3][0], j[3][0]) for t, j in zip(tev, jev)
              if t[0] == "EndStepEvent"]
    assert len(losses) == N_BATCH
    for got, want in losses:
        assert got.shape == want.shape == (1,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if k == 2:   # the second micro-step ran on the frozen initial params
        acc, = [v.name for v in tt.train_program.list_vars()
                if v.name.endswith(".acc_counter")]
        assert tt.scope.find_var(acc).tolist() == [0.0]


def _small_train_func():
    x = ptt.layers.data("x", [4], dtype="float32")
    y = ptt.layers.data("y", [1], dtype="int64")
    pred = ptt.layers.fc(x, size=3)
    loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(pred, y))
    return [loss, pred]


def _small_reader(n=6, seed=0, bad_at=None):
    def r():
        rng = np.random.RandomState(seed)
        for i in range(n):
            if i == bad_at:
                raise IOError("disk gone")
            yield [(rng.rand(4).astype("float32"),
                    np.array([rng.randint(3)], "int64")) for _ in range(4)]
    return r


def _small_trainer(**kw):
    return ptt.Trainer(_small_train_func, lambda: ptt.optimizer.Adam(0.1),
                       place=ptt.CPUPlace(), **kw)


def test_trainer_test_is_side_effect_free():
    t = _small_trainer()
    params = {p.name: t.scope.find_var(p.name).clone()
              for p in t.train_program.all_parameters()}
    m1 = t.test(_small_reader(), ["x", "y"])
    m2 = t.test(_small_reader(), ["x", "y"])
    for n, v in params.items():
        assert torch.equal(t.scope.find_var(n), v), n
    np.testing.assert_array_equal(m1[0], m2[0])
    assert m1[1].shape == (4, 3)
    ops = {op.type for op in t._test_pruned.global_block().ops}
    assert not {"autodiff", "adam"} & ops


def test_save_params_and_inference_model_round_trip(tmp_path):
    t = _small_trainer()
    t.train(1, lambda e: None, _small_reader(), ["x", "y"])
    t.save_params(str(tmp_path / "params"))
    t2 = _small_trainer(param_path=str(tmp_path / "params"))
    for v in t.train_program.list_vars():
        if v.persistable:
            assert torch.equal(t2.scope.find_var(v.name),
                               t.scope.find_var(v.name)), v.name
    t.save_inference_model(str(tmp_path / "infer"), ["x"], [t.metrics[0]])
    x = np.random.RandomState(3).rand(5, 4).astype("float32")
    want, = t.exe.run(t.test_program.prune(["x"], [t.metrics[0].name]),
                      feed={"x": x}, fetch_list=[t.metrics[0]])
    got, = create_predictor(AnalysisConfig(str(tmp_path / "infer"),
                                           use_gpu=False)).run({"x": x})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what,match", [
    ("checkpoint_config", "A.8"), ("rollback", "A.8"), ("mesh", "A.7"),
    ("trainers_env", "A.7")])
def test_refusals_name_their_queue_items(monkeypatch, tmp_path, what,
                                         match):
    with pytest.raises(NotImplementedError, match=match):
        if what == "checkpoint_config":
            _small_trainer(checkpoint_config=ptt.CheckpointConfig(
                str(tmp_path)))
        elif what == "mesh":
            _small_trainer(mesh=object())
        elif what == "trainers_env":
            monkeypatch.setenv("PADDLE_TRAINING_ROLE", "TRAINER")
            monkeypatch.setenv("PADDLE_TRAINERS", "2")
            _small_trainer()
        else:
            ptt.flags.set_flag("nan_policy", "rollback")
            _small_trainer().train(1, lambda e: None, _small_reader(),
                                   ["x", "y"])
    monkeypatch.setenv("PADDLE_TRAINING_ROLE", "PSERVER")
    with pytest.raises(RuntimeError, match="PSERVER"):
        _small_trainer()


def test_data_feeder_pads_ragged():
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        ids = ptt.layers.data("ids", [16], dtype="int64")
        lbl = ptt.layers.data("label", [1], dtype="int64")
    feeder = ptt.DataFeeder([ids, lbl], pad_to={"ids": 16},
                            emit_masks=True)
    feed = feeder.feed([([1, 2, 3], 0), ([4, 5], 1)])
    assert feed["ids"].shape == (2, 16) and feed["ids"].dtype == np.int64
    assert feed["ids_mask"].sum() == 5
    assert feed["label"].shape == (2, 1)
    ragged = ptt.DataFeeder([ids]).feed([([1, 2, 3],), ([4],)])
    np.testing.assert_array_equal(ragged["ids"], [[1, 2, 3], [4, 0, 0]])


def test_reader_decorators_compose():
    r = reader.batch(
        reader.shuffle(lambda: iter(range(100)), buf_size=32, seed=0), 10)
    batches = list(r())
    assert len(batches) == 10
    assert sorted(sum(batches, [])) == list(range(100))
    assert list(reader.chain(lambda: iter([1, 2]),
                             lambda: iter([3]))()) == [1, 2, 3]
    assert list(reader.compose(lambda: iter([1, 2]), lambda: iter(
        [(10, 20), (30, 40)]))()) == [(1, 10, 20), (2, 30, 40)]
    assert list(reader.buffered(lambda: iter(range(7)), 3)()) == list(
        range(7))
    assert list(reader.map_readers(lambda a, b: a + b, lambda: iter([1, 2]),
                                   lambda: iter([10, 20]))()) == [11, 22]
    assert list(reader.firstn(lambda: iter(range(9)), 4)()) == [0, 1, 2, 3]
    shards = [list(reader.elastic_shard(lambda: iter(range(10)), 3, r,
                                        start=1)()) for r in range(3)]
    assert sorted(sum(shards, [])) == list(range(1, 10))
    assert reader.elastic_watermark(1, 3, 3) == 10


def test_reader_errors_propagate():
    def bad_reader():
        yield 1
        raise IOError("disk gone")

    with pytest.raises(IOError):
        list(reader.buffered(bad_reader, 4)())
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        yield 1
        if calls["n"] == 1:
            raise RuntimeError("flake")
        yield 2

    c = reader.cache(flaky)
    with pytest.raises(RuntimeError):
        list(c())
    assert list(c()) == [1, 2] == list(c())


def _port_threads():
    """The port's reader threads alive now.  Only those count: other test
    files of the same worker (the JAX package's readers, whose threads
    are "Thread-N (producer)") may leave threads of their own."""
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(reader.THREAD_PREFIX)}


@pytest.fixture
def thread_snapshot():
    before = _port_threads()
    return lambda: _port_threads() - before


def test_device_prefetch_stages_feeds_and_ends_its_thread(thread_snapshot):
    def raw():
        for i in range(5):
            yield {"a": np.full((2, 4), i, "float32")}

    items = list(reader.device_prefetch(raw, size=2, device="cpu")())
    assert len(items) == 5
    assert all(isinstance(b, reader.DeviceBatch) for b in items)
    assert isinstance(items[0].feed["a"], torch.Tensor)
    assert items[0].size == 2
    assert torch.equal(items[2].feed["a"], torch.full((2, 4), 2.0))
    # producer exceptions reach the consumer, not end-of-data
    def broken():
        yield {"a": np.zeros((1, 1), "float32")}
        raise RuntimeError("decode failed")

    it = reader.device_prefetch(broken, size=2, device="cpu")()
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    # a consumer that stops early ends the producer, which is joined
    it = reader.device_prefetch(raw, size=1, device="cpu")()
    next(it)
    assert [t.name for t in thread_snapshot()] == [
        reader.THREAD_PREFIX + "device_prefetch"]
    it.close()
    assert not thread_snapshot()
    assert ("device_prefetch",) in obs_metrics.REGISTRY.get(
        "reader_buffer_depth")._series


def test_trainer_prefetch_thread_ends_when_the_reader_raises(
        thread_snapshot):
    t = _small_trainer()
    steps = []
    with pytest.raises(IOError, match="disk gone"):
        t.train(1, lambda e: steps.append(e), _small_reader(bad_at=3),
                ["x", "y"], prefetch_depth=2)
    assert not thread_snapshot()
    assert sum(isinstance(e, ptt.EndStepEvent) for e in steps) == 3


def test_sigterm_stops_at_the_step_boundary(thread_snapshot):
    """The handler train() installs takes the signal; the step it
    arrived in finishes, and train() returns at its boundary."""
    t = _small_trainer()
    seen = []

    def handler(e):
        seen.append(e)
        if isinstance(e, ptt.BeginStepEvent) and e.step == 1:
            h = signal.getsignal(signal.SIGTERM)
            assert callable(h)
            h(signal.SIGTERM, None)

    before = signal.getsignal(signal.SIGTERM)
    t.train(2, handler, _small_reader(), ["x", "y"], prefetch_depth=2)
    assert t.preempted
    assert [type(e).__name__ for e in seen] == [
        "BeginEpochEvent", "BeginStepEvent", "EndStepEvent",
        "BeginStepEvent", "EndStepEvent"]
    assert signal.getsignal(signal.SIGTERM) is before
    assert not thread_snapshot()


def test_numeric_guard_verdicts():
    g = rguard.NumericGuard(policy="skip_step", bad_step_limit=3,
                            warmup_steps=2)
    assert [g.observe(v) for v in (2.0, 2.1, 1.9)] == [rguard.OK] * 3
    assert g.observe(float("nan")) == rguard.NAN
    assert g.observe(100.0) == rguard.SPIKE
    assert g.consecutive_bad == 2
    assert g.last_attribution.startswith("unattributed")
    assert g.observe(2.0) == rguard.OK and g.consecutive_bad == 0
    for _ in range(2):
        g.observe(float("inf"))
    with pytest.raises(rguard.CircuitBreakerOpen):
        g.observe(float("inf"))
    with pytest.raises(ValueError, match="nan_policy"):
        rguard.NumericGuard(policy="retry")


@pytest.mark.parametrize("policy", ["raise", "skip_step"])
def test_trainer_guard_policies(policy):
    """A NaN fetched loss (the trainer.step chaos site) raises under
    'raise' and is dropped from the step's event under 'skip_step'."""
    ptt.flags.set_flag("nan_policy", policy)
    ptt.flags.set_flag("chaos_spec", "trainer.step=nan:1.0")
    chaos.reset()
    t = _small_trainer()
    ends = []
    if policy == "raise":
        with pytest.raises(rguard.BadStepError, match="nan_policy=raise"):
            t.train(1, ends.append, _small_reader(n=2), ["x", "y"])
        return
    skipped = obs_metrics.REGISTRY.get("trainer_skipped_steps_total")
    before = skipped.total()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ptt.flags.set_flag("bad_step_limit", 0)
        try:
            t.train(1, ends.append, _small_reader(n=2), ["x", "y"])
        finally:
            ptt.flags.set_flag("bad_step_limit", 5)
    steps = [e for e in ends if isinstance(e, ptt.EndStepEvent)]
    assert len(steps) == 2 and all(e.metrics == [] for e in steps)
    assert skipped.total() == before + 2


def test_trainer_steps_record_metrics_and_traces():
    """Each step counts, times its anatomy and leaves an X-ray trace: a
    trainer.step root with its data-wait, host and device children."""
    from paddle_tpu_torch.observability import tracectx
    steps = obs_metrics.REGISTRY.get("trainer_steps_total")
    hist = obs_metrics.REGISTRY.get("trainer_step_seconds")
    n0, c0 = steps.total(), hist.count
    known = set(tracectx.trace_ids())
    t = _small_trainer()
    t.train(1, lambda e: None, _small_reader(n=3), ["x", "y"])
    assert steps.total() == n0 + 3 and hist.count == c0 + 3
    assert np.isfinite(obs_metrics.REGISTRY.get("trainer_loss").value)
    new = [tid for tid in tracectx.trace_ids() if tid not in known]
    assert len(new) == 3
    names = sorted(sp["name"] for sp in tracectx.spans_for(new[0]))
    assert names == ["trainer.data_wait", "trainer.device", "trainer.host",
                     "trainer.step"]
