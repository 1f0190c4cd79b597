"""Aligned table printer (port of `l3c_tpu/utils/printer.py`)."""
from __future__ import annotations

from typing import List, Sequence


class AlignedPrinter:
    def __init__(self):
        self.rows: List[Sequence[str]] = []

    def append(self, *cols: str):
        self.rows.append([str(c) for c in cols])

    def __str__(self) -> str:
        if not self.rows:
            return ""
        n = max(len(r) for r in self.rows)
        widths = [0] * n
        for r in self.rows:
            for i, c in enumerate(r):
                widths[i] = max(widths[i], len(c))
        return "\n".join(
            "  ".join(c.ljust(widths[i]) for i, c in enumerate(r)).rstrip()
            for r in self.rows)

    def print(self):
        print(str(self))
