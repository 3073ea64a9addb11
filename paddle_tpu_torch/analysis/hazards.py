"""Pre-dispatch hazard lints: the run-context checks the Executor
consults before it runs a program (counterpart of
paddle_tpu/analysis/hazards.py).

They need feed/fetch context, so they live apart from the structural
dataflow lints:

  * ``donated_fetch`` (error): a donated feed is also fetched.  The
    port's executor keeps no reference to its feeds after a run whatever
    ``donate_feeds`` says, but the program is held to the reference's
    contract, so a program that verifies here verifies there;
  * ``unknown_feed`` (warn): a feed name the program declares no var
    for: no op can read it;
  * ``unset_feed_shape`` (warn): a fed var with NO static shape
    recorded, so nothing can check a caller's shape against it;
  * ``lowp_accum`` (warn): a matmul or reduction whose inputs are
    DECLARED fp16/bf16 while the amp plane is off.  The port's programs
    declare f32 even under FLAGS_amp_bf16 (AMP is lowering-time only,
    its products accumulate in f32), so the lint names only a program
    built with 2-byte vars, the precision loss the reference's float16
    transpiler existed to prevent.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

from ..core import flags
from . import traversal
from .findings import ERROR, WARN, AnalysisResult, Finding

PASS = "hazards"

_ACCUM_OPS = frozenset({"mul", "matmul", "bmm", "conv2d",
                        "conv2d_transpose", "reduce_sum", "reduce_mean",
                        "sum", "mean"})
_LOWP = ("float16", "bfloat16")


class HazardPass:
    name = PASS

    def run(self, program, result: AnalysisResult,
            feed_names: Optional[Set[str]] = None,
            fetch_names: Optional[Sequence[str]] = None,
            donate_feeds: bool = False,
            var_dtypes: Optional[Dict[str, str]] = None):
        result.passes_run.append(self.name)
        block = program.global_block()
        feed_names = set(feed_names or ())

        if donate_feeds:
            for n in set(fetch_names or ()) & feed_names:
                result.add(Finding(
                    pass_name=self.name, code="donated_fetch",
                    severity=ERROR,
                    message=(f"feed {n!r} is donated (donate_feeds) AND "
                             f"fetched: the fetch would alias a buffer "
                             f"the step may already have reused — fetch "
                             f"a copy or drop the donation"),
                    block_idx=block.idx, var_names=(n,)))

        for n in sorted(feed_names):
            if not block.has_var(n):
                result.add(Finding(
                    pass_name=self.name, code="unknown_feed",
                    severity=WARN,
                    message=(f"feed {n!r} names no var in the program; "
                             f"no op can read it"),
                    block_idx=block.idx, var_names=(n,)))
                continue
            var = block.var(n)
            if var.shape is None:
                result.add(Finding(
                    pass_name=self.name, code="unset_feed_shape",
                    severity=WARN,
                    message=(f"fed var {n!r} has no static shape "
                             f"recorded: no caller-side shape drift can "
                             f"be checked (the 'feed_shapes' cause of "
                             f"the reference's recompiles) — declare it "
                             f"via layers.data"),
                    block_idx=block.idx, var_names=(n,)))

        if not flags.get_flag("amp_bf16"):
            for i, op in enumerate(block.ops):
                if op.type not in _ACCUM_OPS:
                    continue
                lowp = []
                for n in traversal.op_input_names(op):
                    _, dt = traversal.declared_info(block, n)
                    dt = (var_dtypes or {}).get(n, dt)
                    if dt in _LOWP:
                        lowp.append((n, dt))
                if lowp:
                    names = ", ".join(f"{n} ({d})" for n, d in lowp)
                    result.add(Finding(
                        pass_name=self.name, code="lowp_accum",
                        severity=WARN,
                        message=(f"op {op.type!r} accumulates over "
                                 f"low-precision input(s) {names} with "
                                 f"the amp plane off — enable amp_bf16 "
                                 f"(f32 accumulation, f32 master "
                                 f"params) or cast before reducing"),
                        block_idx=block.idx, op_index=i,
                        op_type=op.type,
                        var_names=tuple(n for n, _ in lowp),
                        callsite=getattr(op, "callsite", None)))
