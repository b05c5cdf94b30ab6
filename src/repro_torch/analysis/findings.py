"""Finding model shared by every analysis pass (port of
``repro.analysis.findings``).

A :class:`Finding` is one rule violation anchored to ``file:line`` (the
anchor is clickable in most terminals/editors).  Severities gate the CLI
exit code: by default only ``error`` findings fail a run, so advisory
``warning``/``info`` findings can accumulate without breaking CI.

Inline suppression: append ``# ra: ignore`` (all rules) or
``# ra: ignore[RA003]`` / ``# ra: ignore[RA001, RA003]`` (specific rule
ids) to the offending source line.  ``repro-analysis`` is accepted as a
long-form alias for ``ra``.
"""
from __future__ import annotations

import enum
import json
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional


class Severity(enum.IntEnum):
    """Ordered so that gating is a plain comparison."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    @classmethod
    def parse(cls, name: str) -> "Severity":
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {name!r}; expected one of "
                f"{[s.name.lower() for s in cls]}"
            ) from None


@dataclass(frozen=True)
class Finding:
    """One analyzer finding with a stable rule id and source anchor."""

    rule: str                 # e.g. "RA001"
    severity: Severity
    message: str
    file: str = "<none>"      # path as given on the command line
    line: int = 0             # 1-based; 0 = whole-file / non-source finding
    col: int = 0              # 0-based column offset (ast convention)
    extra: dict = field(default_factory=dict)  # rule-specific payload

    @property
    def anchor(self) -> str:
        if self.line:
            return f"{self.file}:{self.line}"
        return self.file

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity.name.lower(),
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "extra": self.extra,
        }

    def render(self) -> str:
        return (
            f"{self.anchor}: {self.severity.name.lower()}: "
            f"[{self.rule}] {self.message}"
        )


# --- inline suppression ----------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*(?:ra|repro-analysis)\s*:\s*ignore"
    r"(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?"
)


def suppressed_rules(source_line: str) -> Optional[frozenset]:
    """Rule ids suppressed on ``source_line``.

    Returns ``None`` when the line carries no suppression comment, an
    empty frozenset for a bare ``# ra: ignore`` (suppress everything),
    or the frozenset of named rule ids.
    """
    m = _SUPPRESS_RE.search(source_line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return frozenset()
    return frozenset(r.strip().upper() for r in rules.split(",") if r.strip())


def is_suppressed(finding: Finding, source_lines: list) -> bool:
    """True when the finding's source line carries a matching suppression."""
    if not finding.line or finding.line > len(source_lines):
        return False
    rules = suppressed_rules(source_lines[finding.line - 1])
    if rules is None:
        return False
    return not rules or finding.rule.upper() in rules


# --- report ----------------------------------------------------------------

@dataclass
class Report:
    """Aggregate result of an analysis run (all passes)."""

    findings: list = field(default_factory=list)
    passes_run: list = field(default_factory=list)
    wall_s: float = 0.0
    files_scanned: int = 0

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def count_at_least(self, severity: Severity) -> int:
        return sum(1 for f in self.findings if f.severity >= severity)

    def rule_counts(self) -> dict:
        counts: dict = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return dict(sorted(counts.items()))

    def exit_code(self, fail_on: Severity = Severity.ERROR) -> int:
        return 1 if self.count_at_least(fail_on) else 0

    def to_dict(self) -> dict:
        return {
            "passes": self.passes_run,
            "files_scanned": self.files_scanned,
            "wall_s": round(self.wall_s, 3),
            "rule_counts": self.rule_counts(),
            "counts": {
                s.name.lower(): sum(
                    1 for f in self.findings if f.severity == s
                )
                for s in Severity
            },
            "findings": [f.to_dict() for f in self.findings],
        }

    def render_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=False)

    def render_text(self) -> str:
        lines = []
        order = sorted(
            self.findings, key=lambda f: (-int(f.severity), f.file, f.line)
        )
        for f in order:
            lines.append(f.render())
        n_err = self.count_at_least(Severity.ERROR)
        n_warn = sum(1 for f in self.findings if f.severity == Severity.WARNING)
        n_info = sum(1 for f in self.findings if f.severity == Severity.INFO)
        lines.append(
            f"repro_torch.analysis: {self.files_scanned} file(s), "
            f"passes={','.join(self.passes_run) or 'none'}: "
            f"{n_err} error(s), {n_warn} warning(s), {n_info} info "
            f"in {self.wall_s:.2f}s"
        )
        return "\n".join(lines)
