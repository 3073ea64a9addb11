"""The port's serving plane on the CPU: KV-cache decode against the JAX
DecodeEngine and against the port's own full-recompute forward, the
continuous batcher, admission control, drain and chaos recovery.

The twin of tests/test_serving.py's engine and batcher tests (less the
HTTP routes, whose server is not ported), on its tiny unfused LM (V 97,
L 2, H 2, D 16, F 32, T 24) with max_batch 4, max_len 32 and prompt
buckets (8, 16).  The weights are the JAX build's, initialised in
paddle_tpu and bound into the port's build by name.  Tolerances: greedy
tokens exactly; the K/V slabs at 1e-5 absolute (the same f32 math summed
in another order, entries of order 1).  Sampling is held by its
distribution (torch's Philox is not JAX's threefry): a chi-square test at
p = 1e-4 of 2000 draws against the oracle's softmax.
"""
import os
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import serving
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.observability import flight, goodput, journal
from paddle_tpu_torch.observability import memscope, perfscope, tracectx
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import loadgen

T = 24
KV_TOL = 1e-5
CHI2_P = 1e-4


def _counter_total(name):
    m = obs_metrics.REGISTRY.get(name)
    return 0.0 if m is None else m.total()


def _reset_port_planes():
    serving.reset()
    flags.set_flag("chaos_spec", "")
    flags.set_flag("serving_lazy_bucket_compile", False)
    flags.set_flag("perfscope", False)
    flags.set_flag("memscope", False)
    flags.set_flag("goodput", False)
    chaos.reset()
    flight.reset()
    journal.reset()
    tracectx.reset()
    obs_metrics.clear_exemplars()
    perfscope.reset()
    memscope.reset()
    goodput.reset()


@pytest.fixture(autouse=True)
def port_planes():
    _reset_port_planes()
    yield
    _reset_port_planes()


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=97, tgt_vocab_size=97,
                                 max_length=32, n_layer=2, n_head=2,
                                 d_model=16, d_inner=32, dropout=0.0)


@pytest.fixture(scope="module")
def lm():
    """The JAX build's weights, a prepared JAX DecodeEngine over them, the
    port's build with the same weights bound by name, its prepared
    DecodeEngine on the CPU and its full-forward oracle."""
    pt.reset_default_programs()
    jmain, jstartup = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstartup):
        jtr.build_lm_net(tiny_cfg(jtr), seq_len=T, is_test=True,
                         fused_attention=False, fused_head=False)
    jstartup.random_seed = 3
    jscope = pt.Scope()
    pt.Executor(pt.CPUPlace(), scope=jscope).run(jstartup)
    jparams = jserving.extract_lm_params(jmain, jscope, tiny_cfg(jtr))
    jengine = jserving.DecodeEngine(tiny_cfg(jtr), jparams, max_batch=4,
                                    max_len=32, prompt_buckets=(8, 16))
    jengine.prepare()

    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        _, _, logits = ttr.build_lm_net(tiny_cfg(ttr), seq_len=T,
                                        is_test=True,
                                        fused_attention=False,
                                        fused_head=False)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    ptt.io.params_from_numpy(
        scope, {p.name: np.asarray(jscope.find_var(p.name))
                for p in jmain.all_parameters()}, ptt.CPUPlace())
    params = serving.extract_lm_params(main, scope, tiny_cfg(ttr))
    compiles0 = _counter_total("serving_compiles_total")
    engine = serving.DecodeEngine(tiny_cfg(ttr), params, max_batch=4,
                                  max_len=32, prompt_buckets=(8, 16),
                                  place=ptt.CPUPlace())
    report = engine.prepare()

    def ref_logits(toks):
        pad = np.zeros((1, T), np.int64)
        pad[0, :len(toks)] = toks
        lg, = exe.run(main, feed={"tokens": pad,
                                  "labels": np.zeros((1, T), "int64")},
                      fetch_list=[logits])
        return lg[0, len(toks) - 1]

    def ref_greedy(prompt, n_new):
        """Full-recompute forward per token — the correctness oracle."""
        toks, out = list(prompt), []
        for _ in range(n_new):
            tok = int(np.argmax(ref_logits(toks)))
            toks.append(tok)
            out.append(tok)
        return out

    return SimpleNamespace(
        cfg=tiny_cfg(ttr), engine=engine, jengine=jengine, params=params,
        jparams=jparams, ref_greedy=ref_greedy, ref_logits=ref_logits,
        prepare_report=report,
        prepare_compiles=_counter_total("serving_compiles_total")
        - compiles0)


@pytest.fixture
def fresh_engine(lm):
    lm.engine.reset()
    return lm.engine


@pytest.fixture
def batcher(fresh_engine):
    b = serving.ContinuousBatcher(fresh_engine, queue_limit=16)
    b.start()
    serving.attach(b)
    yield b
    serving.reset()


def _greedy_via_engine(engine, prompts, n_new):
    """Start all prompts in parallel slots; step until each has n_new
    tokens; returns per-prompt token lists."""
    gen = {s: [engine.start_sequence(s, p, temperature=0.0)]
           for s, p in enumerate(prompts)}
    for _ in range(n_new - 1):
        for s, t in engine.decode_step().items():
            gen[s].append(t)
    return [gen[s] for s in range(len(prompts))]


# --- the engine --------------------------------------------------------------

def test_prepare_readies_every_bucket_and_the_step(lm):
    assert lm.engine.prepared_buckets == [8, 16]
    assert set(lm.prepare_report) == {"prefill_8", "prefill_16",
                                      "decode_step", "total_seconds"}
    assert lm.prepare_compiles == 3
    assert lm.engine.device.type == "cpu"
    # prepared twice: nothing more is readied
    before = _counter_total("serving_compiles_total")
    assert set(lm.engine.prepare()) == {"total_seconds"}
    assert _counter_total("serving_compiles_total") == before


def test_kv_decode_token_identical_to_jax_engine_and_full_forward(
        lm, fresh_engine):
    """Batched incremental decode == the JAX engine == the port's
    full-recompute forward, token for token, across bucketed prompt
    lengths in ONE ragged batch."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 97, n).tolist() for n in (5, 8, 13, 16)]
    lm.jengine.reset()
    got = _greedy_via_engine(fresh_engine, prompts, 6)
    assert got == _greedy_via_engine(lm.jengine, prompts, 6)
    for p, g in zip(prompts, got):
        assert g == lm.ref_greedy(p, 6)


def test_kv_slabs_match_the_jax_engine(lm, fresh_engine):
    """The K/V slabs after a ragged prefill and after 6 decode steps
    hold the JAX engine's values in every position each slot wrote."""
    rng = np.random.RandomState(4)
    lens = (3, 8, 11, 16)
    prompts = [rng.randint(1, 97, n).tolist() for n in lens]
    lm.jengine.reset()
    for e in (fresh_engine, lm.jengine):
        for s, p in enumerate(prompts):
            e.start_sequence(s, p)

    def check(extra):
        for s, n in enumerate(lens):
            for mine, theirs in ((fresh_engine._kv_k, lm.jengine._kv_k),
                                 (fresh_engine._kv_v, lm.jengine._kv_v)):
                a = mine[:, s, :, :n + extra].numpy()
                b = np.asarray(theirs)[:, s, :, :n + extra]
                np.testing.assert_allclose(a, b, rtol=0, atol=KV_TOL)

    check(0)
    for _ in range(6):
        assert fresh_engine.decode_step() == lm.jengine.decode_step()
    check(6)
    np.testing.assert_array_equal(fresh_engine._lengths.numpy(),
                                  np.asarray(lm.jengine._lengths))
    np.testing.assert_array_equal(fresh_engine._lengths_host,
                                  fresh_engine._lengths.numpy())


def test_kv_decode_retire_backfill_mid_decode(lm, fresh_engine):
    """A retired slot backfilled MID-DECODE decodes its new sequence
    token-identically while the neighbours keep their caches."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 97, n).tolist() for n in (6, 9, 12)]
    gen = {s: [fresh_engine.start_sequence(s, p)]
           for s, p in enumerate(prompts)}
    for _ in range(2):
        for s, t in fresh_engine.decode_step().items():
            gen[s].append(t)
    fresh_engine.retire_slot(1)
    assert fresh_engine.free_slots() == [1, 3]
    p_new = rng.randint(1, 97, 11).tolist()
    g_new = [fresh_engine.start_sequence(1, p_new)]
    for _ in range(3):
        out = fresh_engine.decode_step()
        assert set(out) == {0, 1, 2}
        g_new.append(out[1])
        for s in (0, 2):
            gen[s].append(out[s])
    assert g_new == lm.ref_greedy(p_new, 4)
    for s in (0, 2):
        assert gen[s] == lm.ref_greedy(prompts[s], 6)


def test_temperature_sampling_and_greedy_mix(lm, fresh_engine):
    """Greedy and temperature slots coexist in one decode step; the
    sampled slot stays in-vocab and the greedy slot stays reference-
    exact."""
    rng = np.random.RandomState(2)
    p0, p1 = rng.randint(1, 97, 7).tolist(), rng.randint(1, 97, 7).tolist()
    g0 = [fresh_engine.start_sequence(0, p0, temperature=0.0)]
    g1 = [fresh_engine.start_sequence(1, p1, temperature=1.0)]
    for _ in range(4):
        out = fresh_engine.decode_step()
        g0.append(out[0])
        g1.append(out[1])
    assert g0 == lm.ref_greedy(p0, 5)
    assert all(0 <= t < 97 for t in g1)


def test_temperature_one_samples_the_oracle_softmax(lm, fresh_engine):
    """2000 first tokens at temperature 1 from one prompt: their counts
    against 2000 x softmax(oracle logits), categories with fewer than 5
    expected merged into one, must pass a chi-square test at p = 1e-4."""
    prompt = np.random.RandomState(3).randint(1, 97, 9).tolist()
    logits = lm.ref_logits(prompt).astype(np.float64)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    n = 2000
    counts = np.zeros(97, np.int64)
    for _ in range(n):
        counts[fresh_engine.start_sequence(0, prompt, temperature=1.0)] += 1
        fresh_engine.retire_slot(0)
    expected = n * probs
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    bound = float(stats.chi2.ppf(1 - CHI2_P, len(obs) - 1))
    assert len(obs) >= 5, "the test needs several categories"
    assert chi2 <= bound, (chi2, bound, obs.tolist())
    # greedy at temperature 0 is the oracle's argmax
    assert fresh_engine.start_sequence(1, prompt) == int(np.argmax(logits))


def test_decode_step_before_prepare_raises(lm):
    e = serving.DecodeEngine(lm.cfg, lm.params, max_batch=2, max_len=32,
                             prompt_buckets=(8,), place=ptt.CPUPlace())
    with pytest.raises(RuntimeError, match="prepare"):
        e.decode_step()
    with pytest.raises(ValueError, match="not prepared"):
        e.start_sequence(0, [1, 2, 3])


def test_engine_refuses_impossible_geometry(lm):
    with pytest.raises(ValueError, match="max_length"):
        serving.DecodeEngine(lm.cfg, lm.params, max_len=64,
                             place=ptt.CPUPlace())
    with pytest.raises(ValueError, match="bucket"):
        serving.DecodeEngine(lm.cfg, lm.params, max_len=32,
                             prompt_buckets=(64,), place=ptt.CPUPlace())


def test_engine_defaults_to_the_card(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.DecodeEngine(lm.cfg, lm.params, max_batch=2, max_len=32,
                             prompt_buckets=(8,))


def test_lazy_bucket_is_refused_then_counted(lm):
    """An added bucket is refused at the door until prepared; under
    serving_lazy_bucket_compile its first request readies it, counted
    as prefill_lazy."""
    e = serving.DecodeEngine(lm.cfg, lm.params, max_batch=2, max_len=32,
                             prompt_buckets=(8,), place=ptt.CPUPlace())
    e.prepare()
    e.add_bucket(16)
    prompt = list(range(1, 13))
    with pytest.raises(ValueError, match="not prepared"):
        e.validate_prompt(len(prompt))
    lazy = obs_metrics.REGISTRY.get("serving_compiles_total").labels(
        kind="prefill_lazy")
    before = lazy.value
    flags.set_flag("serving_lazy_bucket_compile", True)
    assert e.start_sequence(0, prompt) == lm.ref_greedy(prompt, 1)[0]
    assert lazy.value == before + 1
    assert e.prepared_buckets == [8, 16]


def test_kv_occupancy_ledger(lm, fresh_engine):
    flags.set_flag("memscope", True)
    fresh_engine.start_sequence(0, [1, 2, 3, 4, 5])
    fresh_engine.start_sequence(2, list(range(1, 13)))
    fresh_engine.decode_step()
    doc = memscope.status_doc()["kv"]
    per_pos = doc["bytes_per_position"]
    # 2 layers x (K + V) x 2 heads x 8 dims x 4 bytes a position
    assert per_pos == 2 * 2 * 2 * 8 * 4
    assert doc["active_slots"] == 2
    assert doc["written_bytes"] == (6 + 13) * per_pos
    assert doc["reserved_bytes"] == 2 * 32 * per_pos
    assert set(doc["buckets"]) == {"8", "16"}


# --- the batcher -------------------------------------------------------------

def test_cache_capacity_boundary_uses_every_position(lm, fresh_engine,
                                                     batcher):
    """A slot may emit exactly max_len - prompt_len tokens after the
    prefill token: the decode step at lengths == max_len - 1 writes
    the LAST cache position and its emitted token is still valid."""
    prompt = list(range(1, 15))            # len 14, bucket 16
    cap = fresh_engine.max_len - len(prompt) + 1        # incl. prefill
    req = batcher.submit(prompt, max_new_tokens=10_000)
    doc = req.result(timeout=60)
    assert doc["status"] == "ok"
    assert doc["n_tokens"] == cap          # 32 - 14 + 1 = 19
    # reference-exact as far as the T=24 oracle program can see
    n_ref = T - len(prompt)
    assert doc["tokens"][:n_ref] == lm.ref_greedy(prompt, n_ref)


def test_prompt_too_long_rejected_at_the_door(lm, fresh_engine, batcher):
    with pytest.raises(ValueError, match="bucket"):
        batcher.submit(list(range(1, 20)))   # > largest bucket (16)
    with pytest.raises(ValueError, match="empty"):
        batcher.submit([])


def test_loadgen_soak_zero_request_path_compiles(lm, batcher):
    """8 concurrent closed-loop streams against the batcher-fronted LM
    complete with ZERO captures on the request path
    (serving_compiles_total frozen) and p99 per-token latency under
    budget."""
    compiles_before = _counter_total("serving_compiles_total")
    tokens_before = _counter_total("serving_tokens_generated_total")
    rep = loadgen.run_loadgen(
        loadgen.inproc_submit(batcher), streams=8,
        requests_per_stream=3, max_new_tokens=6,
        prompt_len_range=(3, 14), vocab_size=97,
        p99_budget_ms=2000.0)
    assert rep["ok"], rep
    assert rep["counts"]["ok"] == 24
    assert rep["counts"]["gave_up"] == 0
    assert rep["accounted"]
    assert rep["per_token_ms"]["p99"] is not None
    assert rep["per_token_ms"]["p99"] <= 2000.0
    assert _counter_total("serving_compiles_total") == compiles_before
    assert (_counter_total("serving_tokens_generated_total")
            - tokens_before) >= 24 * 6
    doc = serving.status_doc()
    assert doc["attached"] and doc["max_batch"] == 4
    assert doc["requests"]["ok"] >= 24
    assert doc["ttft_s"]["count"] >= 24


def test_eos_stops_generation(lm, batcher):
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 97, 5).tolist()
    ref = lm.ref_greedy(prompt, 8)
    # an eos that does not occur earlier in the greedy tail, so the stop
    # point is unambiguous
    idx = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    req = batcher.submit(prompt, max_new_tokens=8, eos_id=ref[idx])
    doc = req.result(timeout=30)
    assert doc["status"] == "ok"
    assert doc["tokens"] == ref[:idx + 1]    # stops AT the eos token


def test_admission_control_sheds_past_queue_limit(lm, fresh_engine):
    """Bounded queue: past serving_queue_limit submit() raises
    ShedError and the shed counter moves — the 429 contract."""
    b = serving.ContinuousBatcher(fresh_engine, queue_limit=0)
    b.start()
    serving.attach(b)
    shed = obs_metrics.REGISTRY.get("serving_requests_total").labels(
        status="shed")
    before = shed.value
    with pytest.raises(serving.ShedError) as ei:
        b.submit([1, 2, 3])
    assert not ei.value.draining
    assert shed.value == before + 1
    serving.reset()
    assert not b.running


def test_drain_finishes_in_flight_and_sheds_queue(lm, batcher):
    """Drain contract: in-flight sequences finish, queued/new requests
    get EXPLICIT drained/shed responses, nothing hangs."""
    reqs = [batcher.submit(list(range(1, 6)), max_new_tokens=12)
            for _ in range(6)]
    batcher.begin_drain(stop=True)
    docs = [r.result(timeout=30) for r in reqs]
    assert {d["status"] for d in docs} <= {"ok", "drained"}
    for d in docs:
        if d["status"] == "ok":
            assert len(d["tokens"]) == 12
    deadline = time.time() + 10
    while batcher.running and time.time() < deadline:
        time.sleep(0.05)
    assert not batcher.running
    with pytest.raises((serving.ShedError, RuntimeError)):
        batcher.submit([1, 2, 3])


def test_drain_on_command(lm, batcher):
    doc = serving.drain(stop=False)
    assert doc == {"status": "draining", "stop": False, "queued": 0}
    assert batcher.draining and batcher.running
    with pytest.raises(serving.ShedError) as ei:
        batcher.submit([1, 2, 3])
    assert ei.value.draining
    serving.reset()
    with pytest.raises(RuntimeError, match="no serving batcher"):
        serving.drain()


def test_sigterm_begins_drain_and_chains_handler(lm, batcher):
    """SIGTERM drains the serving plane AND still reaches a previously
    installed handler."""
    seen = []
    old = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        batcher.install_signal_handlers()
        req = batcher.submit([2, 3, 4], max_new_tokens=5)
        os.kill(os.getpid(), signal.SIGTERM)
        doc = req.result(timeout=30)
        assert doc["status"] in ("ok", "drained")
        deadline = time.time() + 10
        while batcher.running and time.time() < deadline:
            time.sleep(0.05)
        assert not batcher.running
        assert batcher.draining
        assert seen == [signal.SIGTERM]      # chained, not swallowed
    finally:
        batcher.restore_signal_handlers()
        signal.signal(signal.SIGTERM, old)


def test_submit_after_sigterm_flag_is_drained_synchronously(lm, batcher):
    """A submit racing begin_drain — after the SIGTERM handler set
    ``_drain_requested`` but before the loop honors it — answers
    `drained` synchronously; many submits against a drain in flight each
    terminate exactly once."""
    batcher._drain_requested = True
    depth_before = batcher.queue_depth
    t0 = time.perf_counter()
    with pytest.raises(serving.ShedError) as ei:
        batcher.submit([1, 2, 3], max_new_tokens=4)
    assert ei.value.draining
    assert time.perf_counter() - t0 < 1.0
    assert batcher.queue_depth == depth_before
    batcher._drain_requested = False
    results = []

    def _spam():
        for _ in range(8):
            try:
                r = batcher.submit([4, 5, 6], max_new_tokens=3)
                results.append(r.result(timeout=30)["status"])
            except serving.ShedError as e:
                results.append("drained" if e.draining else "shed")
            except RuntimeError:
                results.append("drained")      # stopped mid-race
    th = threading.Thread(target=_spam)
    th.start()
    batcher.begin_drain(stop=True)
    th.join(timeout=30)
    assert not th.is_alive()
    assert len(results) == 8
    assert set(results) <= {"ok", "drained", "shed"}


def test_decode_chaos_fails_requests_explicitly_and_recovers(lm, batcher):
    """A chaos fault mid-decode fails the in-flight requests with an
    explicit error response; the loop resets the engine (slabs zeroed
    in place) and keeps serving reference-exact tokens afterwards."""
    slab = batcher.engine._kv_k
    flags.set_flag("chaos_spec", "serving.decode_step=raise:1.0")
    req = batcher.submit([5, 6, 7], max_new_tokens=6)
    doc = req.result(timeout=30)
    assert doc["status"] == "error"
    assert "decode step failed" in doc["error"]
    flags.set_flag("chaos_spec", "")
    req2 = batcher.submit([5, 6, 7], max_new_tokens=4)
    doc2 = req2.result(timeout=30)
    assert doc2["status"] == "ok"
    assert doc2["tokens"] == lm.ref_greedy([5, 6, 7], 4)
    assert batcher.running
    assert batcher.engine._kv_k is slab


def test_memory_alloc_chaos_records_the_failure(lm, batcher):
    flags.set_flag("memscope", True)
    flags.set_flag("chaos_spec", "memory.alloc=raise:1.0")
    doc = batcher.submit([5, 6, 7], max_new_tokens=4).result(timeout=30)
    assert doc["status"] == "error"
    flags.set_flag("chaos_spec", "")
    mem = memscope.status_doc()
    assert mem["alloc_failures"] >= 1
    assert mem["last_alloc_failure"]["where"] == "serving.decode_step"
    assert flight.last_bundle()["reason"] == "memory_alloc_failure"


def test_perfscope_and_goodput_see_the_serving_phases(lm, batcher):
    """With the perfscope flag on, every prefill and decode step is a
    regression-watch sample; with goodput on, a drain is charged as
    drain chip-time."""
    flags.set_flag("perfscope", True)
    flags.set_flag("goodput", True)
    doc = batcher.submit([5, 6, 7], max_new_tokens=4).result(timeout=30)
    assert doc["status"] == "ok"
    phases = perfscope.status_doc()["phases"]
    assert phases["serving.prefill"]["count"] == 1
    assert phases["serving.decode_step"]["count"] == 3
    batcher.begin_drain(stop=True)
    deadline = time.time() + 10
    while batcher.running and time.time() < deadline:
        time.sleep(0.05)
    assert not batcher.running
    assert goodput.snapshot()["states"]["drain"] > 0.0


def test_chaos_poisons_torch_tensors_and_flight_leaves_out_a9():
    """The copied chaos plane's tensor poison keeps a torch tensor on its
    device; the flight bundle leaves out the sections of the modules A.9
    ports (cost model, compile log, tensor stats)."""
    flags.set_flag("chaos_spec", "executor.var.h=nan:1.0")
    assert chaos.var_sites_armed()
    t = torch.ones(3)
    out = chaos.poison_value("executor.var.h", t)
    assert isinstance(out, torch.Tensor) and torch.isnan(out).all()
    ids = torch.arange(3)
    assert chaos.poison_value("executor.var.h", ids) is ids
    flags.set_flag("chaos_spec", "")
    doc = flight.bundle("test")
    assert {"events", "counter_deltas", "metrics", "flags"} <= set(doc)
    assert not {"program_costs", "compile_log", "tensor_stats"} & set(doc)
    assert doc["flags"]["serving_max_batch"] == 8
