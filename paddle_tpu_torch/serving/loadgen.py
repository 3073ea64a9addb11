"""Serving load generator — the soak headline.

Counterpart of paddle_tpu/serving/loadgen.py, copied (framework-neutral:
threads and urllib).  N concurrent CLOSED-LOOP client streams (each waits
for its response before issuing the next request) drive a
batcher-fronted LM and the run reports p50/p99 TTFT and per-token
latency, token throughput, and a full admission ledger — every attempt
ends as ``ok``, an explicit ``shed`` (429), or an explicit ``error``;
nothing is silently lost.

The HTTP submitters (``http_submit``, ``http_submit_multi``) drive any
live ``POST /serving/generate`` endpoint; the port's own HTTP worker
and the router's in-process submitter wait for ROADMAP queue A.9.

``python -m paddle_tpu_torch.serving.loadgen --url http://host:port``
drives a live serving endpoint; exit 1 when the p99 per-token budget
(``serving_p99_budget_ms`` or ``--budget-ms``) is exceeded or a stream
gave up.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core import flags
from .batcher import ContinuousBatcher, ShedError

SubmitFn = Callable[[Sequence[int], int, float], dict]


def inproc_submit(batcher: ContinuousBatcher,
                  timeout: float = 60.0) -> SubmitFn:
    """Submit function bound to an in-process batcher."""

    def submit(prompt, max_new_tokens, temperature):
        req = batcher.submit(prompt, max_new_tokens=max_new_tokens,
                             temperature=temperature)
        return req.result(timeout=timeout)

    return submit


def http_submit(url: str, timeout: float = 60.0) -> SubmitFn:
    """Submit function for a remote worker's ``POST /serving/generate``.
    Raises ShedError on 429; ConnectionError family on a dead worker
    (the chaos-kill window) so the stream can retry."""
    import urllib.error
    import urllib.request
    endpoint = url.rstrip("/") + "/serving/generate"

    def submit(prompt, max_new_tokens, temperature):
        body = json.dumps({
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "timeout_s": timeout}).encode()
        req = urllib.request.Request(
            endpoint, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            if e.code == 429:
                raise ShedError(f"shed by server: {detail}") from e
            raise ConnectionError(
                f"HTTP {e.code} from {endpoint}: {detail}") from e
        except urllib.error.URLError as e:
            raise ConnectionError(f"{endpoint} unreachable: {e.reason}") \
                from e

    return submit


def round_robin_submit(targets: Sequence[tuple]) -> SubmitFn:
    """Round-robin over named submit fns: ``targets`` is a
    sequence of ``(name, submit_fn)``.  The returned fn carries a
    ``per_target`` ledger — per-target ok/shed/error counts — so a
    multi-replica soak can assert WHERE traffic landed, not just that
    it terminated."""
    targets = [(str(n), fn) for n, fn in targets]
    if not targets:
        raise ValueError("round_robin_submit: no targets")
    lock = threading.Lock()
    cursor = [0]
    per_target = {n: {"ok": 0, "shed": 0, "error": 0}
                  for n, _ in targets}

    def submit(prompt, max_new_tokens, temperature):
        with lock:
            name, fn = targets[cursor[0] % len(targets)]
            cursor[0] += 1
        try:
            resp = fn(prompt, max_new_tokens, temperature)
        except ShedError:
            with lock:
                per_target[name]["shed"] += 1
            raise
        except Exception:
            with lock:
                per_target[name]["error"] += 1
            raise
        with lock:
            per_target[name]["ok" if resp.get("status") == "ok"
                             else "error"] += 1
        return resp

    submit.per_target = per_target
    return submit


def http_submit_multi(urls: Sequence[str],
                      timeout: float = 60.0) -> SubmitFn:
    """Round-robin HTTP submit over several serving endpoints (the
    multi ``--url`` CLI path): each target keeps its own ledger row."""
    return round_robin_submit(
        [(u, http_submit(u, timeout)) for u in urls])


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def run_loadgen(submit: SubmitFn, streams: int = 8,
                requests_per_stream: int = 4,
                prompt_len_range=(4, 14), max_new_tokens: int = 8,
                temperature: float = 0.0, vocab_size: int = 64,
                p99_budget_ms: Optional[float] = None, seed: int = 0,
                max_attempts: int = 60,
                retry_sleep_s: float = 0.1) -> dict:
    """Drive `streams` closed-loop clients; returns the soak report.

    Every attempt is accounted (ok/shed/error); a request retries shed
    and transport errors up to `max_attempts` before its stream counts
    it as given up — under chaos the retries are what carries the
    stream across a worker restart.
    """
    if p99_budget_ms is None:
        p99_budget_ms = float(flags.get_flag("serving_p99_budget_ms"))
    counts = {"issued": 0, "ok": 0, "shed": 0, "error": 0,
              "gave_up": 0, "tokens": 0, "retried_ok": 0}
    ttfts: List[float] = []
    per_token: List[float] = []
    trace_ids: List[str] = []      # X-ray: one per ok response that
    lock = threading.Lock()        # carried a trace_id (all of them,
    # when request_tracing is on) — the soak's every-request-has-a-
    # retrievable-trace check reads this

    def stream(sid: int):
        rng = np.random.RandomState(seed * 1000 + sid)
        for _ in range(requests_per_stream):
            n = int(rng.randint(prompt_len_range[0],
                                prompt_len_range[1] + 1))
            prompt = rng.randint(1, vocab_size, n).tolist()
            for attempt in range(max_attempts):
                with lock:
                    counts["issued"] += 1
                try:
                    resp = submit(prompt, max_new_tokens, temperature)
                except ShedError:
                    with lock:
                        counts["shed"] += 1
                    time.sleep(retry_sleep_s)
                    continue
                except (ConnectionError, OSError, TimeoutError):
                    with lock:
                        counts["error"] += 1
                    time.sleep(retry_sleep_s * 2)
                    continue
                if resp.get("status") != "ok":
                    with lock:
                        counts["error"] += 1
                    time.sleep(retry_sleep_s)
                    continue
                with lock:
                    counts["ok"] += 1
                    if attempt > 0:
                        # the zero-lost headline's other half: the
                        # request DID succeed after riding through a
                        # shed/kill/drain window on retries
                        counts["retried_ok"] += 1
                    counts["tokens"] += int(resp.get("n_tokens") or 0)
                    if resp.get("trace_id"):
                        trace_ids.append(str(resp["trace_id"]))
                    if resp.get("ttft_s") is not None:
                        ttfts.append(float(resp["ttft_s"]))
                    if (resp.get("latency_s") is not None
                            and resp.get("ttft_s") is not None
                            and (resp.get("n_tokens") or 0) > 1):
                        per_token.append(
                            (resp["latency_s"] - resp["ttft_s"])
                            / (resp["n_tokens"] - 1))
                break
            else:
                with lock:
                    counts["gave_up"] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=stream, args=(i,), daemon=True)
               for i in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0

    p99_tok_ms = _pct(per_token, 99)
    p99_tok_ms = None if p99_tok_ms is None else p99_tok_ms * 1e3
    accounted = (counts["issued"]
                 == counts["ok"] + counts["shed"] + counts["error"])
    budget_ok = (p99_budget_ms <= 0 or p99_tok_ms is None
                 or p99_tok_ms <= p99_budget_ms)
    report = {
        "streams": streams,
        "requests_per_stream": requests_per_stream,
        "duration_s": round(dt, 3),
        "counts": dict(counts),
        "accounted": accounted,
        "tokens_per_sec": round(counts["tokens"] / dt, 2) if dt else 0.0,
        "ttft_ms": {
            "p50": None if not ttfts else _pct(ttfts, 50) * 1e3,
            "p99": None if not ttfts else _pct(ttfts, 99) * 1e3},
        "per_token_ms": {
            "p50": None if not per_token else _pct(per_token, 50) * 1e3,
            "p99": p99_tok_ms},
        "p99_budget_ms": p99_budget_ms,
        "budget_ok": budget_ok,
        "trace_ids": trace_ids,
        # per-target admission rows when the submit fn keeps them
        # (round_robin_submit / http_submit_multi)
        "per_target": {k: dict(v) for k, v in getattr(
            submit, "per_target", {}).items()} or None,
        "ok": accounted and budget_ok and counts["gave_up"] == 0
              and counts["ok"] == streams * requests_per_stream,
    }
    return report


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.loadgen",
        description="Closed-loop serving load generator; nonzero exit "
                    "on SLO-budget violation or lost requests.")
    ap.add_argument("--url", required=True, action="append",
                    help="serving endpoint root, e.g. "
                         "http://127.0.0.1:8080; repeatable — several "
                         "targets round-robin with a "
                         "per-target row in the report")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--budget-ms", type=float, default=None,
                    help="p99 per-token budget (default: the "
                         "serving_p99_budget_ms flag)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    submit = (http_submit(args.url[0]) if len(args.url) == 1
              else http_submit_multi(args.url))
    rep = run_loadgen(submit, streams=args.streams,
                      requests_per_stream=args.requests,
                      max_new_tokens=args.max_new_tokens,
                      temperature=args.temperature,
                      vocab_size=args.vocab,
                      p99_budget_ms=args.budget_ms, seed=args.seed)
    print(json.dumps(rep, indent=1))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main())
