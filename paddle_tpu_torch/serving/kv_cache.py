"""Decode-loop KV cache for the transformer LM.

Counterpart of paddle_tpu/serving/kv_cache.py (``extract_lm_params`` :68,
``DecodeEngine`` :120).  The same trained weights (bound through
:func:`models.transformer.lm_program_spec`) run through an incremental
decode step with pre-allocated per-layer K/V slabs written in place, so
generating a token costs one step over the slot batch, not a full forward.

The decode state is explicit and batched, as in the reference:

  * K/V slabs ``[L, B, H, max_len, d_head]`` f32 — one slab per layer,
    every serving slot side by side, written at per-slot positions
    (``index_copy_`` for a prefill, an indexed store for a decode step).
  * Per-slot sequence state on the device (lengths, last token,
    temperature, the step's active mask) with a host mirror of the
    lengths and the slot map, so the batcher can retire a finished
    sequence and backfill its slot MID-DECODE without touching the other
    slots' caches, and ``decode_step`` never reads the lengths back.
  * Bucketed prompt lengths: a prompt pads up to the smallest
    ``serving_prompt_buckets`` entry; ``prepare()`` readies one prefill
    per bucket and the decode step, so the request path never captures.
  * Greedy + temperature sampling per slot (temperature 0 = argmax,
    matching the full-recompute forward token for token).

On the card ``prepare()`` captures one ``torch.cuda.CUDAGraph`` per prompt
bucket and one for the decode step, on the engine's own stream; the
request path only copies into the graphs' static input buffers and
replays.  ``serving_compiles_total{kind}`` counts the captures.  On the
CPU (``place=CPUPlace()``) there is no graph: the same bodies run eagerly
against the same static buffers, and ``prepare()`` does the same
bookkeeping, so the no-request-path-capture contract is testable there.
A capture that fails raises out of ``prepare()``: the engine never runs
eagerly on the card.

Where the reference differs:

  * the graphs end at the logits; greedy argmax and temperature sampling
    run after the replay with the engine's ``torch.Generator`` (seeded
    from ``seed``), so no generator state lives inside a graph.  torch's
    Philox draws other numbers than JAX's threefry: sampling matches the
    reference in distribution, greedy decoding token for token;
  * ``reset()`` zeros the slabs in place (a captured graph holds their
    addresses) where the reference reallocates them;
  * the reference's persistent executable cache (its :322-353) is left
    out until ROADMAP queue A.10 decides what persists of a graph.

The prefill and decode bodies are jnp code in the reference, not Pallas:
here they are torch math and ``torch.matmul``, with no kernel of this repo.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import flags
from ..core.place import Place, default_place
from ..observability import flight as obs_flight
from ..observability import memscope as obs_memscope
from ..observability import metrics as obs_metrics
from ..observability import tracectx as obs_tracectx
from ..resilience import chaos

_m_compiles = obs_metrics.counter(
    "serving_compiles_total",
    "Serving-plane graph captures (prefill buckets + the decode step; "
    "on the CPU, the same bookkeeping without a graph).  Moves at "
    "prepare() time only; growth under load is a request-path capture "
    "— the storm the bucket grid exists to prevent.",
    ("kind",))
_m_compile_seconds = obs_metrics.gauge(
    "serving_startup_compile_seconds",
    "Total wall time prepare() spent capturing the bucket grid and "
    "decode step.")
_m_prefill = obs_metrics.histogram(
    "serving_prefill_seconds",
    "Prompt prefill latency (one bucket's replay and its first token).")

_NEG = -1e9   # the additive mask value build_lm_net bakes into its bias


def extract_lm_params(program, scope, cfg) -> Dict[str, np.ndarray]:
    """Pull the trained LM weights out of (program, scope) keyed by the
    ROLE names of :func:`models.transformer.lm_program_spec` —
    ``emb``, ``l{i}.ln1.scale`` … ``w_head`` — as host f32 arrays, the
    flat dict :class:`DecodeEngine` binds."""
    from ..framework.executor import to_numpy
    from ..models.transformer import lm_program_spec
    spec = lm_program_spec(program)
    if spec["n_layer"] != cfg.n_layer:
        raise ValueError(
            f"program has {spec['n_layer']} layers but cfg.n_layer="
            f"{cfg.n_layer}")

    def _get(name):
        v = scope.find_var(name)
        if v is None:
            raise ValueError(f"parameter {name!r} missing from scope — "
                             "run the startup program first")
        return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)

    params = {"emb": _get(spec["emb"]), "w_head": _get(spec["w_head"]),
              "ln_f.scale": _get(spec["ln_f"][0]),
              "ln_f.bias": _get(spec["ln_f"][1])}
    for i, lay in enumerate(spec["layers"]):
        params[f"l{i}.ln1.scale"] = _get(lay["ln1"][0])
        params[f"l{i}.ln1.bias"] = _get(lay["ln1"][1])
        params[f"l{i}.ln2.scale"] = _get(lay["ln2"][0])
        params[f"l{i}.ln2.bias"] = _get(lay["ln2"][1])
        for k in ("w_qkv", "w_o", "w_fc1", "b_fc1", "w_fc2", "b_fc2"):
            params[f"l{i}.{k}"] = _get(lay[k])
    return params


def _ln(x, scale, bias, eps=1e-5):
    """layer_norm over the trailing axis: the op's own f32 math (centred
    variance), as the reference's _ln."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class DecodeEngine:
    """Batched incremental decode over ``build_lm_net`` weights.

    Slot protocol (driven by serving/batcher.py, single-threaded):

      1. ``start_sequence(slot, prompt, temperature)`` — bucketed
         prefill writes the prompt's K/V at the slot and returns the
         FIRST generated token (the TTFT token).
      2. ``decode_step()`` — one replay appends one token to every
         active slot (inactive slots compute but are masked).
      3. ``retire_slot(slot)`` — frees the slot for backfill; its cache
         rows are simply overwritten by the next prefill.

    Cache layout: ``lengths[slot]`` tokens occupy K/V positions
    ``[0, lengths)``; ``last_token[slot]`` is the NEXT input, written
    at position ``lengths`` by the decode step before attending.

    ``params`` are host arrays or tensors, moved once to the engine's
    device in f32.  ``place`` defaults to the card (``default_place()``,
    which raises without one); tests pass ``CPUPlace()``.
    """

    def __init__(self, cfg, params: Dict[str, object],
                 max_batch: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0, place: Optional[Place] = None):
        self.cfg = cfg
        self.max_batch = int(max_batch if max_batch is not None
                             else flags.get_flag("serving_max_batch"))
        self.max_len = int(max_len if max_len is not None
                           else cfg.max_length)
        if self.max_len > cfg.max_length:
            raise ValueError(f"max_len {self.max_len} exceeds the "
                             f"model's max_length {cfg.max_length}")
        if prompt_buckets is None:
            prompt_buckets = [
                int(b) for b in str(flags.get_flag(
                    "serving_prompt_buckets")).split(",") if b.strip()]
        buckets = sorted(set(int(b) for b in prompt_buckets))
        self.prompt_buckets = [b for b in buckets if b <= self.max_len]
        if not self.prompt_buckets:
            raise ValueError(
                f"no prompt bucket fits max_len={self.max_len} "
                f"(got {buckets})")
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._cuda = self.device.type == "cuda"
        dev, f32 = self.device, torch.float32
        self._params = {
            k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32))
                ).to(device=dev, dtype=f32)
            for k, v in params.items()}
        from ..models.transformer import position_encoding_table
        self._pos = torch.from_numpy(position_encoding_table(
            cfg.max_length, cfg.d_model)[:self.max_len]).to(dev)
        self._n_head = cfg.n_head
        self._d_head = cfg.d_key
        self._scale = float(cfg.d_key) ** -0.5

        B, L, T = self.max_batch, cfg.n_layer, self.max_len
        kv_shape = (L, B, cfg.n_head, T, cfg.d_key)
        self._kv_k = torch.zeros(kv_shape, dtype=f32, device=dev)
        self._kv_v = torch.zeros(kv_shape, dtype=f32, device=dev)
        # device state: the decode graph's static inputs, never
        # reallocated (reset() zeros them in place)
        self._lengths = torch.zeros(B, dtype=torch.int64, device=dev)
        self._last = torch.zeros(B, dtype=torch.int64, device=dev)
        self._temps = torch.zeros(B, dtype=f32, device=dev)
        self._step_mask = torch.zeros(B, dtype=torch.bool, device=dev)
        self._iB = torch.arange(B, device=dev)
        self._iT = torch.arange(T, device=dev)
        # host mirrors: the slot map, lengths and temperatures
        self._active = np.zeros((B,), bool)
        self._lengths_host = np.zeros((B,), np.int64)
        self._temps_host = np.zeros((B,), np.float32)
        # host-side prompt bucket per slot — the memscope occupancy
        # ledger aggregates waste per bucket from this
        self._slot_bucket = np.zeros((B,), np.int32)
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._stream = torch.cuda.Stream(dev) if self._cuda else None
        self._prefill: Dict[int, tuple] = {}     # bucket -> (static, run)
        self._step: Optional[Callable[[], torch.Tensor]] = None
        self.capture_seconds: Dict[str, float] = {}
        # the logits of the last prefill ([1, V]) or decode step ([B, V]):
        # on the card the graph's output buffer, valid until the next call
        self.last_logits: Optional[torch.Tensor] = None
        if self._cuda:
            torch.cuda.synchronize(dev)
        # construction-time registration (not the request path): lets
        # the memscope census claim the slabs as the serving_kv plane
        obs_memscope.register_kv_engine(self)

    # -- device context -----------------------------------------------------
    @contextlib.contextmanager
    def _on_device(self):
        """The engine's device and stream (the capture's), from whichever
        thread calls: every copy into a static buffer and every replay is
        ordered on that stream.  Autograd off."""
        with torch.no_grad():
            if not self._cuda:
                yield
                return
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                yield

    # -- bodies (eager on the CPU, captured on the card) --------------------
    def _layer(self, p, i, x, attend):
        """One transformer block shared by prefill and decode; the
        caller provides the attention plumbing (cache write + score
        masking differ between the two)."""
        y = _ln(x, p[f"l{i}.ln1.scale"], p[f"l{i}.ln1.bias"])
        qkv = torch.matmul(y, p[f"l{i}.w_qkv"])
        E = self._n_head * self._d_head
        q, k, v = qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
        ctx = attend(i, q, k, v)
        x = x + torch.matmul(ctx, p[f"l{i}.w_o"])
        y2 = _ln(x, p[f"l{i}.ln2.scale"], p[f"l{i}.ln2.bias"])
        h = torch.relu(torch.matmul(y2, p[f"l{i}.w_fc1"])
                       + p[f"l{i}.b_fc1"])
        return x + torch.matmul(h, p[f"l{i}.w_fc2"]) + p[f"l{i}.b_fc2"]

    def _prefill_static(self, bucket: int) -> dict:
        dev = self.device
        r = torch.arange(bucket, device=dev)
        return {"tokens": torch.zeros(bucket, dtype=torch.int64, device=dev),
                "length": torch.ones(1, dtype=torch.int64, device=dev),
                "slot": torch.zeros(1, dtype=torch.int64, device=dev),
                "causal": torch.where(r[None, :] > r[:, None],
                                      _NEG, 0.0).to(torch.float32)}

    def _prefill_body(self, bucket: int, st: dict) -> torch.Tensor:
        """Prefill of ONE prompt padded to `bucket`, written into the
        slot in ``st["slot"]``; returns the logits [1, V] at position
        ``st["length"] - 1``.  Pad positions beyond the length are kept
        out of every real row by the causal mask."""
        p = self._params
        H, dh, D = self._n_head, self._d_head, self.cfg.d_model
        slot, causal = st["slot"], st["causal"]
        x = F.embedding(st["tokens"], p["emb"]) * float(D) ** 0.5 \
            + self._pos[:bucket]

        def heads(t):                           # [T, H*dh] -> [H, T, dh]
            return t.reshape(bucket, H, dh).transpose(0, 1)

        def attend(li, q, k, v):
            kh, vh = heads(k), heads(v)
            self._kv_k[li, :, :, :bucket].index_copy_(0, slot, kh[None])
            self._kv_v[li, :, :, :bucket].index_copy_(0, slot, vh[None])
            s = torch.matmul(heads(q), kh.transpose(1, 2)) * self._scale
            w = torch.softmax(s + causal, dim=-1)
            ctx = torch.matmul(w, vh)                       # [H, T, dh]
            return ctx.transpose(0, 1).reshape(bucket, H * dh)

        for i in range(self.cfg.n_layer):
            x = self._layer(p, i, x, attend)
        x = _ln(x, p["ln_f.scale"], p["ln_f.bias"])
        xlast = x.index_select(0, st["length"] - 1)          # [1, D]
        return torch.matmul(xlast, p["w_head"])             # [1, V]

    def _step_body(self) -> torch.Tensor:
        """One decode step for the WHOLE slot batch: write the pending
        token's K/V at each slot's position, attend over the cache, and
        return the logits [B, V].  Every slot computes (fixed shape, one
        graph); the step mask is applied after the replay, where the idle
        slots' tokens and lengths are kept as they were."""
        p = self._params
        B, H, dh = self.max_batch, self._n_head, self._d_head
        D, T = self.cfg.d_model, self.max_len
        iB = self._iB
        pos = torch.clamp(self._lengths, 0, T - 1)
        x = F.embedding(self._last, p["emb"]) * float(D) ** 0.5 \
            + self._pos[pos]
        valid = self._iT[None, :] <= pos[:, None]            # [B, T]
        bias = torch.where(valid, 0.0, _NEG).to(torch.float32)[:, None, :]

        def attend(li, q, k, v):
            kc, vc = self._kv_k[li], self._kv_v[li]          # [B,H,T,dh]
            kc[iB, :, pos, :] = k.reshape(B, H, dh)
            vc[iB, :, pos, :] = v.reshape(B, H, dh)
            qh = q.reshape(B, H, dh, 1)
            s = torch.matmul(kc, qh).squeeze(-1) * self._scale  # [B,H,T]
            w = torch.softmax(s + bias, dim=-1)
            ctx = torch.matmul(w[:, :, None, :], vc).squeeze(-2)
            return ctx.reshape(B, H * dh)

        for i in range(self.cfg.n_layer):
            x = self._layer(p, i, x, attend)
        x = _ln(x, p["ln_f.scale"], p["ln_f.bias"])
        return torch.matmul(x, p["w_head"])                  # [B, V]

    # -- capture ------------------------------------------------------------
    def _ready(self, body: Callable[[], torch.Tensor]
               ) -> Callable[[], torch.Tensor]:
        """The callable the request path runs for `body`.  On the CPU,
        the body itself.  On the card, a replay of a graph captured on
        the engine's stream after one warm-up run (which writes the
        slabs, so they are saved and restored around it: a slot that is
        live while a bucket is added keeps its cache).  A failed capture
        raises; nothing falls back to eager execution."""
        if not self._cuda:
            return body
        # the static buffers were filled on the caller's stream
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with self._on_device():
            saved = (self._kv_k.clone(), self._kv_v.clone())
            body()
            self._kv_k.copy_(saved[0])
            self._kv_v.copy_(saved[1])
            del saved
        self._stream.synchronize()
        with torch.no_grad(), torch.cuda.device(self.device), \
                torch.cuda.graph(graph, stream=self._stream,
                                 capture_error_mode="thread_local"):
            out = body()

        def replay() -> torch.Tensor:
            graph.replay()
            return out

        replay.graph = graph
        return replay

    def _compile_prefill(self, bucket: int, kind: str) -> float:
        """Ready one prompt bucket's prefill; returns the seconds.
        ``kind`` labels serving_compiles_total: "prefill" from prepare(),
        "prefill_lazy" when a request-path miss captured it under
        serving_lazy_bucket_compile — tagged with the triggering
        request's trace so the capture shows in that request's own
        timeline."""
        tb = time.perf_counter()
        with obs_tracectx.span("serving.compile_bucket", kind="compile",
                               bucket=bucket, lazy=(kind != "prefill")):
            st = self._prefill_static(bucket)
            run = self._ready(lambda: self._prefill_body(bucket, st))
            self._prefill[bucket] = (st, run)
        dt = time.perf_counter() - tb
        self.capture_seconds[f"prefill_{bucket}"] = dt
        _m_compiles.labels(kind=kind).inc()
        obs_flight.record("compile", f"serving.prefill[{bucket}]",
                          bucket=bucket, compile_kind=kind,
                          trace_id=obs_tracectx.current_trace_id())
        return dt

    def prepare(self) -> dict:
        """Ready the full bucket grid + the decode step NOW (graph
        captures on the card), so serving startup cost is one call and
        the request path never captures.  Returns {bucket: seconds} +
        totals; records serving_compiles_total and the startup gauge."""
        t0 = time.perf_counter()
        report = {}
        for bucket in self.prompt_buckets:
            if bucket in self._prefill:
                continue
            report[f"prefill_{bucket}"] = round(
                self._compile_prefill(bucket, kind="prefill"), 3)
        if self._step is None:
            tb = time.perf_counter()
            self._step = self._ready(self._step_body)
            dt = time.perf_counter() - tb
            self.capture_seconds["decode_step"] = dt
            report["decode_step"] = round(dt, 3)
            _m_compiles.labels(kind="decode_step").inc()
            obs_flight.record("compile", "serving.decode_step",
                              batch=self.max_batch)
        total = time.perf_counter() - t0
        _m_compile_seconds.set(total)
        report["total_seconds"] = round(total, 3)
        how = ("captured as CUDA graphs" if self._cuda
               else "eager on the CPU, no graphs")
        print(f"[serving] prepared {len(self.prompt_buckets)} prompt "
              f"bucket(s) {self.prompt_buckets} x batch "
              f"{self.max_batch} in {total:.2f}s (decode step + prefill "
              f"grid {how})")
        return report

    # -- sampling -------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                any_temp: bool) -> torch.Tensor:
        """Greedy where temp == 0, else a categorical draw at
        ``logits / temp`` from the engine's generator; [N] int64."""
        greedy = torch.argmax(logits, dim=-1)
        if not any_temp:
            return greedy
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        probs = torch.softmax(scaled, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(temps > 0.0, sampled, greedy)

    # -- slot lifecycle -------------------------------------------------------
    def reset(self):
        """Forget all sequence state (the prepared graphs survive).  The
        K/V slabs and the device state are zeroed IN PLACE: the graphs
        hold their addresses, and the batcher's recovery path calls this
        after a failed step."""
        with self._on_device():
            for t in (self._kv_k, self._kv_v, self._lengths, self._last,
                      self._temps, self._step_mask):
                t.zero_()
        if self._cuda:
            self._stream.synchronize()
        self._active[:] = False
        self._lengths_host[:] = 0
        self._temps_host[:] = 0.0
        self._slot_bucket[:] = 0

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self._active[i]]

    def active_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if self._active[i]]

    @property
    def occupancy(self) -> float:
        return float(self._active.sum()) / float(self.max_batch)

    @property
    def prepared_buckets(self) -> List[int]:
        return sorted(self._prefill)

    def add_bucket(self, bucket: int):
        """Grow the prompt-bucket grid after construction (an operator
        widening the grid on a live replica).  The new bucket is
        captured at the next prepare() — or lazily on first hit when
        serving_lazy_bucket_compile is on, attributed to the
        triggering request's trace."""
        bucket = int(bucket)
        if bucket > self.max_len:
            raise ValueError(
                f"bucket {bucket} exceeds max_len {self.max_len}")
        if bucket not in self.prompt_buckets:
            self.prompt_buckets = sorted(self.prompt_buckets + [bucket])

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}")

    def validate_prompt(self, prompt_len: int) -> int:
        """Every at-the-door rejection in one place (the batcher calls
        this BEFORE queueing, so a hopeless request errors at submit,
        not as a dead slot later): bucket fit, room to generate, AND —
        unless serving_lazy_bucket_compile allows a request-path
        capture — a PREPARED bucket.  Returns the bucket."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len >= self.max_len:
            raise ValueError(
                f"prompt length {prompt_len} leaves no room to "
                f"generate (max_len {self.max_len})")
        bucket = self.bucket_for(prompt_len)
        if bucket not in self._prefill \
                and not flags.get_flag("serving_lazy_bucket_compile"):
            raise ValueError(
                f"prompt bucket {bucket} is not prepared — call "
                f"prepare() (or enable serving_lazy_bucket_compile "
                f"to pay the capture on the request path)")
        return bucket

    def remaining_capacity(self, slot: int) -> int:
        """Tokens this slot can still EMIT.  The cache holds positions
        [0, max_len); a decode step at lengths == max_len - 1 writes
        the final position and still emits a valid token (whose K/V is
        never needed), so capacity is max_len - lengths, not one less."""
        return self.max_len - int(self._lengths_host[slot])

    def start_sequence(self, slot: int, prompt: Sequence[int],
                       temperature: float = 0.0) -> int:
        """Bucketed prefill of `prompt` into `slot`; returns the first
        generated token.  One replay — never a capture, unless the
        bucket is lazy and serving_lazy_bucket_compile allows it."""
        if self._active[slot]:
            raise ValueError(f"slot {slot} is still active")
        n = len(prompt)
        bucket = self.validate_prompt(n)
        if bucket not in self._prefill:
            if not flags.get_flag("serving_lazy_bucket_compile"):
                raise RuntimeError(
                    f"bucket {bucket} not prepared — call prepare() "
                    "before serving (request-path captures are "
                    "forbidden)")
            # opt-in escape hatch: capture NOW, attributed — the span
            # lands inside the active request's X-ray timeline
            self._compile_prefill(bucket, kind="prefill_lazy")
        st, run = self._prefill[bucket]
        toks = np.zeros((bucket,), np.int64)
        toks[:n] = np.asarray(prompt, np.int64)
        temperature = float(temperature)
        t0 = time.perf_counter()
        with self._on_device():
            st["tokens"].copy_(torch.from_numpy(toks))
            st["length"].fill_(n)
            st["slot"].fill_(slot)
            logits = self.last_logits = run()
            temps = torch.full((1,), temperature, dtype=torch.float32,
                               device=self.device)
            tok = self._sample(logits, temps, temperature > 0.0)
            self._lengths[slot] = n
            self._last[slot:slot + 1].copy_(tok)
            self._temps[slot] = temperature
            tok = int(tok.item())
        _m_prefill.observe(time.perf_counter() - t0)
        self._lengths_host[slot] = n
        self._temps_host[slot] = temperature
        self._active[slot] = True
        self._slot_bucket[slot] = bucket
        if obs_memscope.enabled():
            obs_memscope.note_kv(self)
        return tok

    def retire_slot(self, slot: int):
        self._active[slot] = False
        if obs_memscope.enabled():
            obs_memscope.note_kv(self)

    def decode_step(self) -> Dict[int, int]:
        """Advance every active slot one token (ONE replay); returns
        {slot: token}.  Slots whose cache is full are excluded (the
        batcher must retire them).  The lengths come from the host
        mirror: the step reads back only the new tokens."""
        if self._step is None:
            raise RuntimeError("call prepare() first")
        runnable = self._active & (self._lengths_host < self.max_len)
        if not runnable.any():
            return {}
        # chaos site: a simulated allocation failure at the serving
        # dispatch — the shared memory.alloc catalog entry; memscope
        # (when on) records the failure in a flight bundle first
        try:
            chaos.trigger("memory.alloc")
        except chaos.InjectedFault:
            if obs_memscope.enabled():
                obs_memscope.note_alloc_failure("serving.decode_step",
                                                label="serving.decode")
            raise
        any_temp = bool((self._temps_host[runnable] > 0.0).any())
        T = self.max_len
        with self._on_device():
            mask = self._step_mask
            mask.copy_(torch.from_numpy(runnable))
            logits = self.last_logits = self._step()
            toks = self._sample(logits, self._temps, any_temp)
            toks = torch.where(mask, toks, self._last)
            self._last.copy_(toks)
            self._lengths.copy_(torch.where(
                mask, torch.clamp(self._lengths + 1, max=T), self._lengths))
            host = toks.cpu().numpy()
        self._lengths_host = np.where(
            runnable, np.minimum(self._lengths_host + 1, T),
            self._lengths_host)
        if obs_memscope.enabled():
            obs_memscope.note_kv(self)
        return {int(i): int(host[i]) for i in np.where(runnable)[0]}
