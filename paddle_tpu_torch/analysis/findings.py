"""Finding records: the structured output of every analysis pass.

Counterpart of paddle_tpu/analysis/findings.py: each pass emits Finding
records instead of prose, so the Executor's gate, the lint CLI and the
metrics plane consume one shape.  The record schema string is the JAX
package's (``paddle_tpu.analysis.v1``), so the records of both packages
compare field by field.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..observability import metrics as obs_metrics

SCHEMA = "paddle_tpu.analysis.v1"

ERROR = "error"
WARN = "warn"
INFO = "info"
_SEV_ORDER = {ERROR: 0, WARN: 1, INFO: 2}

_m_findings = obs_metrics.counter(
    "analysis_findings_total",
    "Static-analysis findings emitted by the program verifier / lint "
    "pass manager (paddle_tpu_torch/analysis), by pass and severity.",
    ("pass", "severity"))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from one pass over one Program.

    ``op_index`` is the op's position in ``program.blocks[block_idx]
    .ops`` (structural feed/fetch/data ops included).  -1 means
    the finding is not anchored to a single op (e.g. a missing fetch).
    ``callsite`` is the user-code ``file:line`` that appended the op,
    when the program was built in this process (None for deserialized
    programs).
    """
    pass_name: str
    code: str
    severity: str
    message: str
    block_idx: int = 0
    op_index: int = -1
    op_type: Optional[str] = None
    var_names: Tuple[str, ...] = ()
    callsite: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "pass": self.pass_name,
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_index": self.op_index,
            "op_type": self.op_type,
            "var_names": list(self.var_names),
            "callsite": self.callsite,
        }

    def __str__(self):
        loc = ""
        if self.op_index >= 0:
            loc = f" [block {self.block_idx} op #{self.op_index}"
            if self.op_type:
                loc += f" {self.op_type!r}"
            loc += "]"
        site = f" ({self.callsite})" if self.callsite else ""
        return f"{self.severity}:{self.code}{loc} {self.message}{site}"


class AnalysisResult:
    """Ordered findings of one verifier run, errors first.  Each finding
    added counts in ``analysis_findings_total``."""

    def __init__(self):
        self.findings: List[Finding] = []
        # passes that ran (for report/debug; dead_op may be skipped
        # when no fetch list is known)
        self.passes_run: List[str] = []
        # op types whose output shapes degraded to unknown (no infer
        # rule and no meta evaluation) — not findings, but the CLI's -v
        # view shows them
        self.unknown_shape_ops: List[str] = []

    def add(self, finding: Finding):
        self.findings.append(finding)
        _m_findings.labels(**{"pass": finding.pass_name,
                              "severity": finding.severity}).inc()

    # -- views ---------------------------------------------------------
    def sorted(self) -> List[Finding]:
        return sorted(self.findings,
                      key=lambda f: (_SEV_ORDER.get(f.severity, 9),
                                     f.block_idx, f.op_index))

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {"schema": SCHEMA,
                "counts": self.counts(),
                "passes": list(dict.fromkeys(self.passes_run)),
                "findings": [f.to_dict() for f in self.sorted()]}

    def report(self, max_findings: int = 50) -> str:
        """Human-readable multi-line summary (the CLI / raise text)."""
        fs = self.sorted()
        lines = [f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s), "
                 f"{len(self.findings) - len(self.errors) - len(self.warnings)} "
                 f"info finding(s)"]
        for f in fs[:max_findings]:
            lines.append("  " + str(f))
        if len(fs) > max_findings:
            lines.append(f"  ... {len(fs) - max_findings} more")
        return "\n".join(lines)

    def __repr__(self):
        c = self.counts()
        return (f"AnalysisResult(errors={c.get(ERROR, 0)}, "
                f"warnings={c.get(WARN, 0)}, infos={c.get(INFO, 0)})")
