"""Observability plane (counterpart of paddle_tpu/observability/): the
modules the serving plane imports.

  * :mod:`.metrics` — Counter/Gauge/Histogram registry with labeled
    series, exemplars and Prometheus-text / JSON exposition.
  * :mod:`.tracectx` — request X-ray: per-request trace context, bounded
    span store, histogram exemplars, SLO-breach captures.
  * :mod:`.flight` — always-on bounded flight recorder and its JSON
    diagnostic bundle.
  * :mod:`.journal` — append-only JSONL fleet event journal.
  * :mod:`.goodput` — chip-time accounting (the batcher's drain span).
  * :mod:`.memscope` — the serving KV-occupancy ledger and OOM forensics.
  * :mod:`.perfscope` — the per-phase step-time regression watch.

These are copies of the reference's modules, less what reached JAX or
what nothing in the port calls yet: memscope's census, perfscope's
roofline, the flight bundle's cost, compile-log and tensor-stats
sections, and goodput's feeders other than serving with its offline
reconstructor wait for ROADMAP queue A.9, as do the HTTP server, alerts,
fleet and the CLIs' other modules.  Nothing is imported eagerly: each
caller imports the modules it uses.
"""
