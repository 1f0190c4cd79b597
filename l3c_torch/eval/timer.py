"""Hierarchical wall-clock timer for the codec and the tester.

Port of `l3c_tpu/eval/timer.py` (the reference's StackTimeLogger): nested
scopes, per-iteration means, the first sample of a scope dropped as
warm-up. PyTorch returns before the card has finished, so a scope timed
for a CUDA device ends in `torch.cuda.synchronize()`: its time is the
work's, not the enqueue's.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class StackTimer:
    def __init__(self, skip: int = 0,
                 device: Optional[torch.device] = None):
        """device: the device the timed work runs on; scopes synchronize
        with it when it is a CUDA device."""
        self._prefix: List[str] = []
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._order: List[str] = []
        self._skip = skip
        self._iteration = 0
        self._sync = device is not None and device.type == "cuda"

    @contextlib.contextmanager
    def prefix_scope(self, name: str):
        self._prefix.append(name)
        try:
            yield
        finally:
            self._prefix.pop()

    @contextlib.contextmanager
    def run(self, name: str):
        key = "/".join(self._prefix + [name])
        t0 = time.perf_counter()
        try:
            yield
            if self._sync:
                torch.cuda.synchronize()
        finally:
            if self._iteration >= self._skip:
                if key not in self._times:
                    self._order.append(key)
                self._times[key].append(time.perf_counter() - t0)

    def next_iteration(self):
        self._iteration += 1

    def means(self) -> Dict[str, float]:
        """Per-scope means with the warm-up excluded: a scope with >= 2
        samples drops its FIRST one (cuDNN and allocator warm-up); a
        single-sample scope keeps it, so one-image runs still report."""
        return {k: (sum(v[1:]) / len(v[1:]) if len(v) >= 2 else v[0])
                for k, v in self._times.items() if v}

    def lasts(self) -> Dict[str, float]:
        return {k: v[-1] for k, v in self._times.items() if v}

    def report(self, which: str = "mean") -> str:
        vals = self.means() if which == "mean" else self.lasts()
        lines = []
        for k in self._order:
            if k not in vals:
                continue
            depth = k.count("/")
            label = k.rsplit("/", 1)[-1] if depth == 0 else k
            lines.append(f"{'  ' * depth}{label}: "
                         f"{vals[k] * 1000:.1f}ms")
        return "\n".join(lines)


class NoOpTimer:
    """Stand-in that times and synchronizes nothing."""

    @contextlib.contextmanager
    def prefix_scope(self, name: str):
        yield

    @contextlib.contextmanager
    def run(self, name: str):
        yield

    def next_iteration(self):
        pass

    def means(self):
        return {}

    def lasts(self):
        return {}

    def report(self, which: str = "mean"):
        return ""
