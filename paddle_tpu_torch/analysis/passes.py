"""Pass manager: the whole-program verifier (counterpart of
paddle_tpu/analysis/passes.py).

Read-only passes over the Program IR emit findings; callers decide
(warn / raise / exit 1).

Entry points:
  * ``verify_program(program, ...)`` — full verification (shape
    inference + dataflow + hazards) -> AnalysisResult;
  * ``quick_lints(program, ...)`` — the cheap O(ops) subset the
    Executor runs in warn mode (no meta evaluation);
  * ``check_transpiled(program, name)`` — transpiler post-condition:
    re-verify the rewritten program in strict mode and RAISE on any
    error finding, turning a silent miscompile into a named
    diagnostic.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

from ..core.enforce import EnforceNotMet
from ..framework import registry as _registry
from .dataflow import DataflowPass
from .findings import AnalysisResult
from .hazards import HazardPass
from .shape_inference import ShapeInferencePass


class ProgramVerificationError(EnforceNotMet):
    """Raised when verification rejects a program (error-severity
    findings under verify_program=error / a transpiler post-condition).
    Carries the full AnalysisResult as ``.result``."""

    def __init__(self, message: str, result: AnalysisResult):
        super().__init__(message)
        self.result = result


def _norm_feed(feed) -> Optional[Set[str]]:
    if feed is None:
        return None
    return set(feed)        # dict -> keys; sequence -> names


def _norm_fetch(fetch_list) -> Optional[Sequence[str]]:
    if fetch_list is None:
        return None
    out = []
    for f in fetch_list:
        out.append(f if isinstance(f, str) else getattr(f, "name", str(f)))
    return out


def verify_program(program=None,
                   feed=None,
                   fetch_list=None,
                   scope=None,
                   donate_feeds: bool = False,
                   strict_shapes: bool = False,
                   feed_shapes: Optional[Dict[str, tuple]] = None
                   ) -> AnalysisResult:
    """Run every analysis pass over ``program``; returns the findings.

    ``feed`` may be a feed dict or an iterable of feed names; None
    means "every data var is fed" (the lint-CLI view).  ``fetch_list``
    accepts Variables or names; None skips the fetch-relative lints
    (missing_fetch, dead_op).  ``strict_shapes`` promotes meta-evaluation
    failures on fully-known shapes to errors (the transpiler
    post-condition mode).  ``feed_shapes`` overrides the declared shapes
    of fed vars with runtime shapes (the Executor passes the actual
    batch)."""
    from ..framework.program import default_main_program
    program = program or default_main_program()
    feed_names = _norm_feed(feed)
    fetch_names = _norm_fetch(fetch_list)

    result = AnalysisResult()
    env = ShapeInferencePass().run(program, result,
                                   feed_shapes=feed_shapes,
                                   strict=strict_shapes)
    DataflowPass().run(program, result, feed_names=feed_names,
                       fetch_names=fetch_names, scope=scope)
    HazardPass().run(program, result, feed_names=feed_names,
                     fetch_names=fetch_names, donate_feeds=donate_feeds,
                     var_dtypes={n: d for n, (s, d) in env.items()
                                 if d is not None})
    return result


def quick_lints(program,
                feed=None,
                fetch_list=None,
                scope=None,
                donate_feeds: bool = False) -> AnalysisResult:
    """The O(ops) dict-walk subset (dataflow + hazards, NO meta shape
    evaluation): what the Executor runs under verify_program=warn."""
    result = AnalysisResult()
    DataflowPass().run(program, result, feed_names=_norm_feed(feed),
                       fetch_names=_norm_fetch(fetch_list), scope=scope)
    HazardPass().run(program, result, feed_names=_norm_feed(feed),
                     fetch_names=_norm_fetch(fetch_list),
                     donate_feeds=donate_feeds)
    return result


def check_transpiled(program, transpiler: str) -> AnalysisResult:
    """Transpiler post-condition: the rewritten program must re-verify
    clean.  Raises ProgramVerificationError naming the transpiler on
    any error-severity finding; returns the result otherwise."""
    result = verify_program(program, strict_shapes=True)
    errs = result.errors
    if errs:
        raise ProgramVerificationError(
            f"{transpiler} produced a program that fails verification "
            f"— a transpiler bug, not a user error.  Findings:\n"
            + result.report(), result)
    return result


def maybe_check_transpiled(program, transpiler: str):
    """The hook the transpilers call: post-condition verification
    unless verify_program=off (the escape hatch)."""
    from ..core import flags
    if str(flags.get_flag("verify_program")) == "off":
        return None
    return check_transpiled(program, transpiler)


# --- test-isolation hook (the port's test fixtures) ------------------------
_BUILTIN_RULES = None


def _snapshot_builtin_rules():
    global _BUILTIN_RULES
    if _BUILTIN_RULES is None:
        _BUILTIN_RULES = set(_registry._INFER_RULES)


_snapshot_builtin_rules()


def reset():
    """Drop infer rules registered by a test and zero the findings
    metric family — per-test isolation."""
    from .findings import _m_findings
    for t in list(_registry._INFER_RULES):
        if t not in (_BUILTIN_RULES or ()):
            _registry.unregister_shape_infer(t)
    _m_findings.reset()
