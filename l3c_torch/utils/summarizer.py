"""TensorBoard scalars for the trainer.

Port of the scalar half of `l3c_tpu/utils/summarizer.py`'s SafeWriter:
it writes through torch's SummaryWriter where the `tensorboard` package
is installed and does nothing where it is not. The images, histograms
and figures of the heavy summaries are ROADMAP.md item 14.
"""
from __future__ import annotations


class SafeWriter:
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

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
