"""TensorBoard summaries for the trainer: scalars, and the heavy
summaries' images, histograms and figures.

Port of `l3c_tpu/utils/summarizer.py`:
- Summarizer: emits into a writer while enabled for a (prefix, step)
- to_image, bottleneck_image, symbol_histogram, add_scale_summaries:
  payloads from a network output's symbols
- ps_figure: observed (p_x) against predicted (p_y) symbol distribution
  bars; only where matplotlib imports (None otherwise)
- SafeWriter: writes through torch's SummaryWriter where the
  `tensorboard` package is installed and does nothing where it is not.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Summarizer:
    """Collects (tag -> payload) while enabled; flushes to a writer."""

    def __init__(self, writer=None):
        self.writer = writer
        self._enabled_prefix: Optional[str] = None
        self._step = 0

    def enable(self, prefix: str, step: int):
        self._enabled_prefix = prefix
        self._step = step

    def disable(self):
        self._enabled_prefix = None

    @property
    def enabled(self) -> bool:
        return self._enabled_prefix is not None and self.writer is not None

    def _tag(self, tag: str) -> str:
        return f"{self._enabled_prefix}/{tag}"

    def scalar(self, tag: str, value):
        if self.enabled:
            self.writer.add_scalar(self._tag(tag), float(value), self._step)

    def scalars(self, values: Dict[str, float]):
        for k, v in values.items():
            self.scalar(k, v)

    def image(self, tag: str, img_hw3_or_hw: np.ndarray):
        if self.enabled:
            self.writer.add_image(self._tag(tag), to_image(img_hw3_or_hw),
                                  self._step, dataformats="HWC")

    def histogram(self, tag: str, values: np.ndarray):
        if self.enabled:
            self.writer.add_histogram(self._tag(tag), np.asarray(values),
                                      self._step)

    def figure(self, tag: str, fig):
        if self.enabled and fig is not None and hasattr(
                self.writer, "add_figure"):
            self.writer.add_figure(self._tag(tag), fig, self._step)


def to_image(arr: np.ndarray) -> np.ndarray:
    """Any 2D/3D float or int array -> uint8 HWC, min-max scaled."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / (hi - lo + 1e-9) * 255.0).astype(np.uint8)
    return arr


def bottleneck_image(syms_hw: np.ndarray, L: int) -> np.ndarray:
    """Grayscale symbol map in [0, 255] uint8 of symbols in [0, L)."""
    s = np.asarray(syms_hw, np.float32)
    if not (s.min() >= 0 and s.max() < L):
        raise ValueError(f"symbols in [{s.min()}, {s.max()}], not in "
                         f"[0, {L})")
    return (s / L * 255.0).astype(np.uint8)


def symbol_histogram(syms: np.ndarray, L: int) -> np.ndarray:
    """Normalized observed symbol distribution p_x, (L,)."""
    counts = np.bincount(np.asarray(syms).reshape(-1), minlength=L)
    return counts / max(1, counts.sum())


def add_scale_summaries(summarizer: Summarizer, out, L: int):
    """Per scale above 0 of an `Out` (the image's symbols, its first
    image): one grayscale image per channel of symbols in [0, L), and the
    histogram of all its symbols."""
    if not summarizer.enabled:
        return
    for scale in range(1, len(out.S)):
        syms = np.asarray(out.S[scale].cpu())
        for c in range(syms.shape[-1]):
            summarizer.image(f"bn/{scale}/c{c}",
                             bottleneck_image(syms[0, ..., c], L))
        summarizer.histogram(f"bn_syms/{scale}", syms.reshape(-1))


def ps_figure(p_x: np.ndarray, p_y: np.ndarray):
    """Side-by-side bars of the observed symbol distribution p_x (counts,
    normalised here) and the predicted one p_y: where the model's
    distribution leaves the data's. A matplotlib Figure, or None where
    matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    p_x = np.asarray(p_x, np.float64)
    p_x = p_x / max(1e-12, p_x.sum())
    p_y = np.asarray(p_y, np.float64)
    fig, ax = plt.subplots(figsize=(8, 3))
    idx = np.arange(len(p_x))
    w = 0.4
    ax.bar(idx - w, p_x, width=w, label="p_x (observed)", align="edge")
    ax.bar(idx, p_y, width=w, label="p_y (predicted)", align="edge",
           alpha=0.7)
    ax.set_xlabel("symbol")
    ax.legend()
    fig.tight_layout()
    return fig


class SafeWriter:
    """Writes through torch's SummaryWriter; without `tensorboard` every
    call does nothing."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:          # no tensorboard: summaries are off
            self._w = None
        else:
            self._w = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def add_image(self, tag, img, step, dataformats="HWC") -> None:
        if self._w is not None:
            self._w.add_image(tag, to_image(img), step,
                              dataformats=dataformats)

    def add_histogram(self, tag, values, step) -> None:
        if self._w is not None:
            self._w.add_histogram(tag, np.asarray(values), step)

    def add_figure(self, tag, fig, step) -> None:
        if self._w is not None and fig is not None:
            self._w.add_figure(tag, fig, step)

    def add_histogram_counts(self, tag, counts, edges, step) -> None:
        """A histogram from counts bucketed on the device (`edges`, one
        more than `counts`)."""
        if self._w is None:
            return
        counts = np.asarray(counts, np.float64)
        edges = np.asarray(edges, np.float64)
        mids = 0.5 * (edges[:-1] + edges[1:])
        n = float(counts.sum())
        if n == 0:
            return
        self._w.add_histogram_raw(
            tag, min=float(edges[0]), max=float(edges[-1]), num=int(n),
            sum=float((counts * mids).sum()),
            sum_squares=float((counts * mids ** 2).sum()),
            bucket_limits=edges[1:].tolist(),
            bucket_counts=counts.tolist(), global_step=step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
