"""Findings and reports of the port's hot-path checks (the JAX
package's ``staticcheck/report.py``).

A ``Finding`` is one (check, subject) verdict; a ``Report`` is the
ordered collection for one run. Reports render two ways: a human
console summary and a machine-readable JSON document.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass
class Finding:
    """One verdict: ``check`` is the check ID (``SC-DON`` ...),
    ``subject`` names what was checked (a hot-path program, an op, or a
    ``path:qualname:call`` source site)."""

    check: str
    subject: str
    ok: bool
    detail: str = ""
    waived: bool = False
    waiver_reason: str = ""
    data: dict = dataclasses.field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return self.ok or self.waived

    def to_dict(self) -> dict:
        d = {"check": self.check, "subject": self.subject, "ok": self.ok,
             "detail": self.detail}
        if self.waived:
            d["waived"] = True
            d["waiver_reason"] = self.waiver_reason
        if self.data:
            d["data"] = _jsonable(self.data)
        return d


def _jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bool, int, str)) or x is None:
        return x
    if isinstance(x, float):
        return round(x, 6)
    return str(x)


@dataclasses.dataclass
class Report:
    findings: list[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(f.passed for f in self.findings)

    def failed_checks(self) -> list[str]:
        """Sorted unique check IDs with at least one unwaived failure."""
        return sorted({f.check for f in self.findings if not f.passed})

    def by_check(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.check, []).append(f)
        return out

    def check_ok(self, check: str) -> Optional[bool]:
        fs = [f for f in self.findings if f.check == check]
        if not fs:
            return None
        return all(f.passed for f in fs)

    def function_verdicts(self) -> dict[str, dict[str, bool]]:
        """Per hot-path program, the invariant verdicts that have a
        per-function meaning (donation / sync-free / dtype planes), the
        slice a benchmark record carries."""
        invariant = {"SC-DON": "donation", "SC-SYNC": "sync_free",
                     "SC-DTYPE": "dtype_planes"}
        out: dict[str, dict[str, bool]] = {}
        for f in self.findings:
            key = invariant.get(f.check)
            if key is None:
                continue
            # SC-DTYPE subjects may carry a per-shape suffix
            # ("prog:int8(...)"); verdicts aggregate per program.
            func = f.subject.split(":", 1)[0]
            d = out.setdefault(func, {})
            d[key] = bool(f.passed) and d.get(key, True)
        return out

    def to_dict(self) -> dict:
        checks = {c: all(f.passed for f in fs)
                  for c, fs in self.by_check().items()}
        return {
            "schema": 1,
            "ok": self.ok,
            "checks": checks,
            "failed_checks": self.failed_checks(),
            "functions": self.function_verdicts(),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def human(self, verbose: bool = False) -> str:
        lines = []
        for check, fs in sorted(self.by_check().items()):
            n_fail = sum(not f.passed for f in fs)
            n_waiv = sum(f.waived for f in fs)
            mark = "PASS" if n_fail == 0 else "FAIL"
            extra = f", {n_waiv} waived" if n_waiv else ""
            lines.append(f"[{mark}] {check}: {len(fs)} finding(s){extra}")
            for f in fs:
                if f.passed and not verbose:
                    continue
                status = ("waived" if f.waived
                          else "ok" if f.ok else "VIOLATION")
                lines.append(f"    {status:9s} {f.subject}  {f.detail}")
                if f.waived and f.waiver_reason:
                    lines.append(f"              reason: {f.waiver_reason}")
        verdict = "OK" if self.ok else (
            "FAILED: " + ", ".join(self.failed_checks()))
        lines.append(f"staticcheck: {verdict}")
        return "\n".join(lines)
