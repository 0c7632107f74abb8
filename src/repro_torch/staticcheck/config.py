"""``staticcheck.toml`` of the port: waivers and footprint tolerances
(the JAX package's ``staticcheck/config.py``).

The file lives beside this module and records every *intentional*
exception to the invariants, each with a reason, so a new violation can
only land by editing a reviewed file, never silently.

Format::

    schema = 1

    [[waivers]]
    check = "SC-AST"                                 # check ID
    subject = "src/repro_torch/gateway/metrics.py:*" # pattern; * is the wildcard
    reason = "host-side wall-clock metrics; no device tensors here"
    device = "cpu"       # optional: the waiver holds on that device only

    [footprint]                 # SC-FOOT default tolerance bands
    flops_ratio = [0.5, 3.0]    # measured/analytic must fall inside
    bytes_ratio = [0.2, 12.0]

    [footprint.ops.flash_attention]   # per-op override
    bytes_ratio = [0.2, 24.0]

A ``device`` waiver covers what only one device's code does: the CPU
has no kernel for some products the card's tick makes (see the port's
file), so its programs take another formulation there.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tomllib
from typing import Optional

DEFAULT_FLOPS_RATIO = (0.5, 3.0)
DEFAULT_BYTES_RATIO = (0.2, 12.0)

#: the port's waiver file
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "staticcheck.toml")


def repo_root() -> str:
    """The repo root: nearest ancestor of this file with pyproject.toml,
    falling back to the current directory."""
    d = os.path.dirname(os.path.abspath(__file__))
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.getcwd()
        d = parent


def _pattern_match(pattern: str, subject: str) -> bool:
    """Literal match with ``*`` as the only wildcard. Deliberately not
    fnmatch: subjects contain ``[q8_0]``-style brackets that fnmatch
    would read as character classes."""
    rx = ".*".join(re.escape(part) for part in pattern.split("*"))
    return re.fullmatch(rx, subject) is not None


@dataclasses.dataclass(frozen=True)
class Waiver:
    check: str
    subject: str          # literal pattern, '*' matches any run of chars
    reason: str
    device: str = ""      # "" (any device) or a device type ("cpu")

    def matches(self, check: str, subject: str,
                device: Optional[str] = None) -> bool:
        """``device``: the run's device type; None matches any waiver."""
        return (self.check == check and _pattern_match(self.subject, subject)
                and (device is None or not self.device
                     or self.device == device))


@dataclasses.dataclass
class StaticcheckConfig:
    waivers: list[Waiver] = dataclasses.field(default_factory=list)
    flops_ratio: tuple[float, float] = DEFAULT_FLOPS_RATIO
    bytes_ratio: tuple[float, float] = DEFAULT_BYTES_RATIO
    op_ratios: dict[str, dict[str, tuple[float, float]]] = \
        dataclasses.field(default_factory=dict)
    path: str = ""

    @classmethod
    def load(cls, path: Optional[str] = None) -> "StaticcheckConfig":
        """Parse a ``staticcheck.toml`` (default: the port's, beside this
        module). A missing file yields the built-in defaults with no
        waivers."""
        path = path or DEFAULT_PATH
        cfg = cls(path=path)
        if not os.path.exists(path):
            return cfg
        with open(path, "rb") as fh:
            doc = tomllib.load(fh)
        for w in doc.get("waivers", []):
            cfg.waivers.append(Waiver(check=str(w["check"]),
                                      subject=str(w["subject"]),
                                      reason=str(w.get("reason", "")),
                                      device=str(w.get("device", ""))))
        foot = doc.get("footprint", {})
        if "flops_ratio" in foot:
            cfg.flops_ratio = tuple(foot["flops_ratio"])  # type: ignore
        if "bytes_ratio" in foot:
            cfg.bytes_ratio = tuple(foot["bytes_ratio"])  # type: ignore
        for op, band in foot.get("ops", {}).items():
            cfg.op_ratios[op] = {k: tuple(v) for k, v in band.items()
                                 if k != "reason"}
        return cfg

    def waiver_for(self, check: str, subject: str,
                   device: Optional[str] = None) -> Optional[Waiver]:
        for w in self.waivers:
            if w.matches(check, subject, device):
                return w
        return None

    def ratio_band(self, op: str, kind: str) -> tuple[float, float]:
        """Tolerance band for ``kind`` in {"flops_ratio", "bytes_ratio"}
        for op ``op`` (per-op override, else the default)."""
        band = self.op_ratios.get(op, {}).get(kind)
        if band is not None:
            return band
        return self.flops_ratio if kind == "flops_ratio" else \
            self.bytes_ratio
