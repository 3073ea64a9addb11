"""Dataflow lints over the Program IR (counterpart of
paddle_tpu/analysis/dataflow.py).

Whole-program static checks emitting structured findings (findings.py):

  * ``undefined_read`` (error): an op input that no earlier op
    produces and that is neither fed, persistable, a data var, nor
    visible from an ancestor block — the Executor would stop mid-run
    with "is not materialised";
  * ``missing_fetch`` (error): a fetch name nothing defines;
  * ``dead_op`` (warn): an op none of whose outputs reach a fetch, a
    persistable write, or any downstream reader — fetch- and
    GRAD-aware: liveness flows backwards from the fetch set and
    persistable state through the autodiff op's params and grads;
  * ``double_write`` (warn): two ops write the same var in one block —
    env shadowing, a transpiler-rewrite hazard (control-flow carry init
    writes and in-place @GRAD rewrites are exempt);
  * ``orphan_param`` (warn): a Parameter declared in the program that
    no op reads or writes (left behind by a partial rewrite).
"""
from __future__ import annotations

from typing import Optional, Sequence, Set

from ..framework.program import Parameter
from . import traversal
from .findings import ERROR, WARN, AnalysisResult, Finding

PASS = "dataflow"

# control-flow ops re-write their carried vars by design: an earlier
# init write (fill_constant) + the loop's write is the documented
# pattern, not a hazard
_CARRY_WRITERS = frozenset({"while", "conditional_block", "scan",
                            "static_rnn_scan", "increment_loop_counter"})


class DataflowPass:
    name = PASS

    def run(self, program, result: AnalysisResult,
            feed_names: Optional[Set[str]] = None,
            fetch_names: Optional[Sequence[str]] = None,
            scope=None):
        result.passes_run.append(self.name)
        block = program.global_block()
        persistable = {v.name for v in program.list_vars()
                       if v.persistable}
        data_vars = {v.name for v in program.list_vars() if v.is_data}
        # scope-provided state counts as defined even when the program
        # forgot to mark it persistable (executor contract: only
        # persistables ride in, so don't silently widen beyond it)
        fed = set(feed_names) if feed_names is not None else set(data_vars)

        self._undefined_reads(program, result, block, fed, persistable,
                              data_vars)
        self._double_writes(result, block)
        if fetch_names is not None:
            self._missing_fetch(result, block, fed, persistable,
                                fetch_names)
            self._dead_ops(program, result, block, persistable,
                           fetch_names)
        self._orphan_params(program, result)

    # ------------------------------------------------------------------
    def _undefined_reads(self, program, result, block, fed, persistable,
                         data_vars):
        defined = set(fed) | persistable
        # feeds not named in the feed set but declared as data vars are
        # STILL undefined reads — that is exactly the "fetch ran before
        # its producer / forgot to feed" trace crash, caught statically
        for i, op in enumerate(block.ops):
            if op.type in traversal.STRUCTURAL_OPS:
                continue
            for slot, names in op.inputs.items():
                for n in names:
                    if n and n not in defined:
                        what = ("is a data var missing from the feed"
                                if n in data_vars else
                                "has no producer before this op and is "
                                "neither fed nor persistable")
                        result.add(Finding(
                            pass_name=self.name, code="undefined_read",
                            severity=ERROR,
                            message=(f"op {op.type!r} reads {slot}:"
                                     f"{n!r}, which {what}"),
                            block_idx=block.idx, op_index=i,
                            op_type=op.type, var_names=(n,),
                            callsite=getattr(op, "callsite", None)))
            defined.update(traversal.op_output_names(op))
        # sub-blocks: conservative — anything defined anywhere in an
        # ancestor is visible (control-flow carry ordering is the
        # executor's business); only truly nonexistent names flag
        if len(program.blocks) > 1:
            all_defined = set(defined)
            for b in program.blocks[1:]:
                sub_defined = set(all_defined)
                for i, op in enumerate(b.ops):
                    if op.type in traversal.STRUCTURAL_OPS:
                        continue
                    for slot, names in op.inputs.items():
                        for n in names:
                            if n and n not in sub_defined \
                                    and not b.has_var(n):
                                result.add(Finding(
                                    pass_name=self.name,
                                    code="undefined_read",
                                    severity=ERROR,
                                    message=(f"op {op.type!r} in "
                                             f"sub-block {b.idx} reads "
                                             f"{slot}:{n!r}, which is "
                                             f"defined nowhere"),
                                    block_idx=b.idx, op_index=i,
                                    op_type=op.type, var_names=(n,),
                                    callsite=getattr(op, "callsite",
                                                     None)))
                    sub_defined.update(traversal.op_output_names(op))

    # ------------------------------------------------------------------
    def _double_writes(self, result, block):
        writers: dict = {}
        for i, op in enumerate(block.ops):
            if op.type in traversal.STRUCTURAL_OPS:
                continue
            for n in traversal.op_output_names(op):
                writers.setdefault(n, []).append((i, op))
        from ..framework.program import GRAD_SUFFIX
        for n, ws in writers.items():
            if len(ws) < 2:
                continue
            if any(op.type in _CARRY_WRITERS for _, op in ws):
                continue        # loop-carry init + loop write pattern
            if GRAD_SUFFIX in n:
                # GRAD-aware: clip, regularization and the distributed
                # transpilers rewrite gradients IN PLACE (autodiff writes
                # g, the inserted op writes g back) so the optimizer ops
                # need no rewiring — the documented idiom, not a hazard
                continue
            i, op = ws[-1]
            result.add(Finding(
                pass_name=self.name, code="double_write", severity=WARN,
                message=(f"var {n!r} is written by "
                         f"{len(ws)} ops (op #"
                         f"{', #'.join(str(j) for j, _ in ws)}); later "
                         f"writes shadow earlier ones in the step"),
                block_idx=block.idx, op_index=i, op_type=op.type,
                var_names=(n,), callsite=getattr(op, "callsite", None)))

    # ------------------------------------------------------------------
    def _missing_fetch(self, result, block, fed, persistable,
                       fetch_names):
        produced = set(fed) | persistable
        for op in block.ops:
            produced.update(traversal.op_output_names(op))
        for n in fetch_names:
            if n not in produced:
                result.add(Finding(
                    pass_name=self.name, code="missing_fetch",
                    severity=ERROR,
                    message=(f"fetch {n!r} is produced by no op and is "
                             f"neither fed nor persistable"),
                    block_idx=block.idx, var_names=(n,)))

    # ------------------------------------------------------------------
    def _dead_ops(self, program, result, block, persistable,
                  fetch_names):
        """Backward liveness from fetches + persistable writes.  Reads
        from sub-blocks keep a parent var live (conservative)."""
        sub_reads: Set[str] = set()
        for b in program.blocks[1:]:
            for op in b.ops:
                sub_reads.update(traversal.op_input_names(op))
        needed = set(fetch_names) | sub_reads
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            if op.type in traversal.STRUCTURAL_OPS:
                continue
            outs = traversal.op_output_names(op)
            live = (not outs                      # side-effect-only op
                    or any(n in needed for n in outs)
                    or any(n in persistable for n in outs))
            if live:
                needed.update(traversal.op_input_names(op))
            else:
                result.add(Finding(
                    pass_name=self.name, code="dead_op", severity=WARN,
                    message=(f"op {op.type!r} writes only "
                             f"{sorted(outs)!r}, which nothing reads, "
                             f"fetches, or persists — dead code the "
                             f"step runs for nothing"),
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var_names=tuple(outs),
                    callsite=getattr(op, "callsite", None)))

    # ------------------------------------------------------------------
    def _orphan_params(self, program, result):
        used: Set[str] = set()
        for _, _, op in traversal.iter_ops(program):
            used.update(traversal.op_input_names(op))
            used.update(traversal.op_output_names(op))
        block = program.global_block()
        for name, var in block.vars.items():
            if isinstance(var, Parameter) and name not in used:
                result.add(Finding(
                    pass_name=self.name, code="orphan_param",
                    severity=WARN,
                    message=(f"parameter {name!r} is declared (and will "
                             f"be loaded from the scope) but no op "
                             f"reads or writes it"),
                    block_idx=block.idx, var_names=(name,)))
