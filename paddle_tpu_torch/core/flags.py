"""Process-wide config plane (counterpart of paddle_tpu/core/flags.py).

Only the flags the ported slices read are declared, with the reference's
defaults: the executor's NaN/Inf scans and its verification gate, the
trainer's and its guard's, the serving plane's, and those of the
observability and resilience modules that serving imports (metrics,
tracectx, journal, flight, memscope, perfscope, goodput, chaos).  Each
help string says what the flag does in the port.  Like the reference, each flag is overridable
via a ``PTPU_<NAME>`` environment variable at import and mutable at
runtime via set_flag/get_flag.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_FLAGS: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = ""):
    env_name = "PTPU_" + name.upper()
    env = os.environ.get(env_name)
    value = default
    if env is not None:
        try:
            if isinstance(default, bool):
                value = env.lower() in ("1", "true", "yes")
            elif isinstance(default, int):
                value = int(env)
            elif isinstance(default, float):
                value = float(env)
            else:
                value = env
        except ValueError as e:
            raise ValueError(
                f"malformed value for flag {name!r}: {env_name}={env!r} "
                f"is not a valid {type(default).__name__} ({e})") from e
    _FLAGS[name] = value


def get_flag(name: str) -> Any:
    return _FLAGS[name]


def all_flags() -> Dict[str, Any]:
    return dict(_FLAGS)


def set_flag(name: str, value: Any):
    if name not in _FLAGS:
        raise KeyError(f"Unknown flag {name!r}")
    _FLAGS[name] = value


define_flag("check_nan_inf", False,
            "Scan every fetched value for NaN/Inf (ref FLAGS_check_nan_inf).")
define_flag("check_nan_inf_per_op", False,
            "Debug mode: run the program eagerly (un-jitted) and scan "
            "every op's outputs, naming the first op that produces "
            "NaN/Inf (the reference's per-op scan, operator.cc:829). "
            "Slow; for localization only.")
define_flag("rng_seed", 0, "Global RNG seed used when a program has no seed.")
define_flag("amp_bf16", False,
            "Mixed precision: f32 matmul and attention inputs enter the "
            "tensor cores as bfloat16 (f32 master params), applied at "
            "lowering time (ops/math_ops.py amp_inputs, amp_result, "
            "amp_matmul).  The kernels accumulate in f32; the cuBLAS "
            "products do when torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction is off.  The "
            "convolutions (ops/nn_ops.py conv2d) take the same casts: "
            "both operands bf16, the output stays bf16, cuDNN "
            "accumulates in f32.  Without the flag an f32 convolution is "
            "full f32 only when torch.backends.cudnn.allow_tf32 is off: "
            "PyTorch turns it ON by default (unlike torch.backends.cuda."
            "matmul.allow_tf32), and cuDNN then rounds the operands to "
            "TF32; chip_smoke.py turns both off.  The package sets "
            "neither cudnn.deterministic nor cudnn.benchmark.")
define_flag("quantize_dtype", "",
            "Real low-precision matmul execution (ops/quantize_ops.py): "
            "'' = off; 'int8' = dynamic-scale int8 x int8 -> int32 "
            "products; 'e4m3'/'e5m2' = fp8 products with f32 "
            "accumulation.  Applies to the mul/matmul/bmm op family at "
            "lowering time (math_ops.amp_matmul), with straight-through "
            "gradients through the AMP-policy product: the training-side "
            "twin of QuantizeTranspiler.freeze_program, which emits "
            "quantized programs whatever this flag says.  An unknown "
            "spelling raises EnforceNotMet at the first product.  The "
            "meta evaluation of shape inference runs with it off, as "
            "with amp_bf16.")
define_flag("fuse_block", False,
            "Fuse whole transformer blocks (LN -> attention -> residual "
            "-> LN -> MLP -> residual) into single fused_transformer_"
            "block ops via transpiler/fused_block.py pattern matching; "
            "the op runs the hand-written block kernel "
            "(kernels/fused_block.py) on the card and its plain torch "
            "version on the CPU.")
define_flag("verify_program", "warn",
            "Static program verification before the Executor first runs "
            "a (program, feed, fetch) key (paddle_tpu_torch/analysis): "
            "'off' = no verification, outputs unchanged; 'warn' "
            "(default) = run the O(ops) dataflow and hazard lints once per "
            "key and emit ONE RuntimeWarning per (program, fetch list) "
            "with error-severity findings; 'error' = also run shape "
            "inference (the lowerings on meta tensors) and REJECT the "
            "program with a ProgramVerificationError before any op runs "
            "or any kernel launches.  The verdict is kept per key, so a "
            "key is verified once.")

# --- the trainer (trainer.py) -----------------------------------------------
define_flag("prefetch_depth", 0,
            "Trainer input pipeline: number of feed batches the "
            "device-prefetch wrapper (reader.device_prefetch) stages on "
            "device AHEAD of the training step (double buffering = 2). "
            "0 disables; feed build + host->device copy then happen "
            "synchronously inside the step's data wait.")
define_flag("input_bound_warn_fraction", 0.5,
            "Trainer input-bound warning: warn once per train() when "
            "the cumulative data-wait time (reader next + feed build) "
            "exceeds this fraction of total step time.  0 disables.")
define_flag("nan_policy", "raise",
            "Numeric-guard policy for a NaN/Inf or loss-spike step in "
            "Trainer.train: raise | skip_step | rollback.  The port's "
            "Trainer refuses rollback, which restores a checkpoint "
            "(ROADMAP queue A.8).")
define_flag("bad_step_limit", 5,
            "Circuit breaker: consecutive bad (NaN/Inf/spike) steps "
            "tolerated before Trainer.train raises regardless of "
            "nan_policy. 0 disables the breaker.")

# --- observability (metrics, tracectx, journal, flight) ----------------------
define_flag("metrics", True,
            "Enable the observability metrics registry; when off "
            "every inc/set/observe is a no-op.")
define_flag("request_tracing", True,
            "Request/step X-ray tracing: per-request trace ids, "
            "span capture and histogram exemplars.  Off = "
            "zero-overhead no-ops, byte-identical outputs.")
define_flag("journal_path", "",
            "Append-only JSONL event journal (observability/journal.py, "
            "schema paddle_tpu.journal.v1): structured lifecycle events "
            "— in the port, serving drains, chaos injections, goodput "
            "segments and alloc failures — stamped with the clock pair "
            "and the ambient trace id.  Empty disables (no file, no "
            "ring, zero overhead).")
define_flag("journal_rotate_bytes", 64_000_000,
            "Rotate the journal to <path>.1 (atomic os.replace) "
            "when a writer opens a file already larger than this "
            "many bytes.  Unlike the per-run runlog the journal "
            "appends across restarts; rotation only bounds "
            "growth.  0 = never rotate.")
define_flag("flight_recorder_path", "",
            "Where the flight recorder (observability/flight.py) writes "
            "its JSON diagnostic bundle; in the port, memscope dumps "
            "one on an allocation failure at the serving dispatch. "
            "Empty: the bundle is still built and kept in memory "
            "(flight.last_bundle()), but no file is written.")
define_flag("flight_recorder_events", 256,
            "Ring-buffer capacity of the always-on flight recorder "
            "(recent spans, compile/chaos/guard/retry events). "
            "0 disables event recording entirely.")

# --- perf attribution (observability/perfscope.py) ---------------------------
define_flag("perfscope", False,
            "Per-phase step-time regression watch (observability/"
            "perfscope.py): the serving batcher's prefill and decode "
            "steps are timed per phase, and a phase's rolling median "
            "against its frozen baseline median is published as the "
            "perf_regression_ratio gauge.  Off: nothing is recorded.")
define_flag("perf_regression_factor", 2.0,
            "Regression-watch trip point: a phase's rolling step-time "
            "median exceeding its frozen baseline median by this "
            "factor marks the phase regressed (perf_regression_ratio "
            "gauge).  <= 1 disables the watch.")
define_flag("perf_baseline_window", 32,
            "Samples per phase the regression watch keeps: the FIRST "
            "window freezes as the baseline, the newest window is the "
            "rolling median compared against it.")

# --- memory attribution (observability/memscope.py) --------------------------
define_flag("memscope", False,
            "Serving memory attribution (observability/memscope.py): "
            "the decode engine's K/V-slab occupancy ledger (reserved "
            "vs written positions per slot and per prompt bucket, as "
            "the serving_kv_* gauges) and, at the memory.alloc chaos "
            "site, a journaled alloc-failure event with a flight "
            "bundle.  Off: no serving-path work.")

# --- chip-time accounting (observability/goodput.py) -------------------------
define_flag("goodput", False,
            "Timecard chip-time accounting (observability/goodput.py): "
            "a per-rank wall-clock state machine that charges the "
            "serving batcher's drains to the drain state and the gaps "
            "between them to idle, published as chip_seconds_total"
            "{state}, goodput_fraction and badput_fraction.  Off: no "
            "boundary does any work.")

# --- resilience plane (resilience/chaos.py) ----------------------------------
define_flag("chaos_spec", "",
            "Deterministic fault-injection spec, "
            "'site=kind[:prob[:arg]][;...]' — e.g. "
            "'trainer.step=nan:0.1;task_queue.rpc=raise:0.2'. Empty "
            "disables every fault point (zero-overhead no-ops). Grammar "
            "and site catalog: docs/RESILIENCE.md.")
define_flag("chaos_seed", 0,
            "Seed for the fault-injection schedule; the same (spec, seed) "
            "reproduces the identical fault sequence.")

# --- serving plane (serving/: kv_cache, batcher, loadgen) --------------------
define_flag("serving_max_batch", 8,
            "Decode-slot count of the serving plane "
            "(serving/kv_cache.py DecodeEngine): the continuous "
            "batcher advances this many sequences per decode step, "
            "retiring finished slots and backfilling from the queue "
            "at step boundaries.")
define_flag("serving_queue_limit", 64,
            "Admission control: pending requests past this bound are "
            "SHED with an explicit rejection (ShedError / HTTP 429) "
            "instead of queueing unboundedly — the load-shedding half "
            "of the serving SLO story.  0 sheds everything (drain "
            "mode for tests).")
define_flag("serving_prompt_buckets", "32,64,128",
            "Comma list of prompt-length buckets the decode engine "
            "readies a prefill for at prepare() time (a CUDA graph "
            "capture on the card); a prompt pads up to the smallest "
            "fitting bucket so the request path never captures.")
define_flag("serving_max_new_tokens", 32,
            "Default per-request generation cap when a request does "
            "not name its own (serving/batcher.py).")
define_flag("serving_p99_budget_ms", 0.0,
            "Serving SLO bar: loadgen (serving/loadgen.py) fails its "
            "run when p99 per-token latency exceeds this many "
            "milliseconds, and a request whose TTFT or per-token "
            "latency breaches it auto-captures an X-ray bundle keyed "
            "by its trace id (observability/tracectx.py).  0 = report "
            "only, no assertion, no captures.")
define_flag("serving_lazy_bucket_compile", False,
            "Allow the decode engine to ready a missing prompt bucket "
            "ON the request path (a CUDA graph capture on the card, "
            "recorded as a compile span inside the triggering "
            "request's X-ray timeline and as serving_compiles_total"
            "{kind=prefill_lazy}).  Off: an unprepared bucket is an "
            "error, never a silent capture.")
