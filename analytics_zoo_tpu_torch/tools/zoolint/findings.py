"""Finding: one zoolint diagnostic, with a baseline-stable fingerprint.

Baselines must survive unrelated edits, so the suppression key is
``(code, path, symbol)`` — the enclosing ``Class.method`` qualname —
NOT the line number, which shifts on every edit above the finding.
Line/col are carried for display only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str        # stable rule id, e.g. "ZL401"
    path: str        # repo-relative, forward slashes
    line: int
    col: int
    symbol: str      # enclosing qualname ("Class.method", "func", "<module>")
    message: str

    @property
    def key(self) -> Tuple[str, str, str]:
        """The baseline-matching fingerprint."""
        return (self.code, self.path, self.symbol)

    @property
    def docs(self) -> str:
        """The rule-catalog docs anchor for this finding's code."""
        from .catalog import anchor_for
        return anchor_for(self.code)

    def to_dict(self) -> dict:
        """The --format json shape: the dataclass fields plus the
        docs anchor (CI links findings straight to the catalog)."""
        return {**dataclasses.asdict(self), "docs": self.docs}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.symbol}] {self.message}")
