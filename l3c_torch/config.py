"""Network configuration: frozen dataclasses whose defaults are `cr.cf`.

The port's own copy of `l3c_tpu/config.py`'s specs (the port imports
nothing of `l3c_tpu`). `.cf` file parsing waits for the CLI port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EncConfig:
    num_blocks: int = 8
    feed_F: bool = True


@dataclasses.dataclass(frozen=True)
class DecConfig:
    num_blocks: int = 8
    skip: bool = True


@dataclasses.dataclass(frozen=True)
class QConfig:
    C: int = 5
    L: int = 25
    levels_range: Tuple[float, float] = (-1.0, 1.0)
    sigma: float = 2.0


@dataclasses.dataclass(frozen=True)
class ProbConfig:
    K: int = 10


@dataclasses.dataclass(frozen=True)
class MsConfig:
    """Network config; field names mirror configs/ms/cr.cf. The RGB
    bicubic baselines (`rgb_bicubic_baseline`) are not ported yet."""
    num_scales: int = 3
    Cf: int = 64
    kernel_size: int = 3
    enc: EncConfig = EncConfig()
    dec: DecConfig = DecConfig()
    q: QConfig = QConfig()
    prob: ProbConfig = ProbConfig()

    def __post_init__(self):
        if self.q.C == 3:
            # the RGB-vs-bottleneck split keys on C == 3 (the reference's
            # logistic_mixture.py:68-73): a 3-channel bottleneck would get
            # RGB-style 4-parameter mixtures
            raise ValueError("q.C == 3 collides with the RGB channel-count "
                             "heuristic; use C != 3 for bottlenecks")

    @property
    def padding_fac(self) -> int:
        return 2 ** self.num_scales
