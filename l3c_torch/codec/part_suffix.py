"""`.partN` multi-file naming for auto-cropped encodes.

Mirrors the reference's bitcoding/part_suffix_helper.py: big images are
stored as `out.l3c.part0 ... out.l3c.partN`; decode detects and iterates
the parts in index order.
"""
from __future__ import annotations

import glob
import os
import re
from typing import List

_RE = re.compile(r"\.part(\d+)$")


def make_part_suffix(i: int) -> str:
    return f".part{i}"


def contains_part_suffix(p: str) -> bool:
    return _RE.search(p) is not None


def base_without_part(p: str) -> str:
    return _RE.sub("", p)


def iter_part_paths(p: str) -> List[str]:
    """All sibling part files of `p`, sorted by part index."""
    base = base_without_part(p)
    paths = glob.glob(glob.escape(base) + ".part*")
    with_idx = []
    for q in paths:
        m = _RE.search(q)
        if m:
            with_idx.append((int(m.group(1)), q))
    return [q for _, q in sorted(with_idx)]


def part_paths_for_encode(base: str, n: int) -> List[str]:
    return [base + make_part_suffix(i) for i in range(n)]


def assert_no_parts(base: str):
    existing = iter_part_paths(base + ".part0")
    if existing:
        raise FileExistsError(f"part files already exist: {existing}")


def remove_parts(base: str):
    for q in iter_part_paths(base + ".part0"):
        os.remove(q)
