"""Building-block layers: same-padded convs, ResBlock, pixel-shuffle.

NCHW throughout (PyTorch's native layout, cuDNN's fast path). Conv
padding is `k//2` for plain convs and `rate` for dilated ones, matching
the reference's default_conv and the JAX package's explicit padding.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

# RGB statistics used for input normalization (EDSR / DIV2K means; scaled
# by 255 at use sites).
RGB_MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)


def conv(cin: int, cout: int, kernel_size: int, stride: int = 1,
         rate: int = 1) -> nn.Conv2d:
    """default_conv: same-pad (dilation-aware), OIHW weights, with bias."""
    pad = kernel_size // 2 if rate == 1 else rate
    return nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
                     dilation=rate)


class ResBlock(nn.Module):
    """conv-ReLU-conv with identity skip."""

    def __init__(self, n_feats: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = conv(n_feats, n_feats, kernel_size)
        self.conv2 = conv(n_feats, n_feats, kernel_size)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW pixel shuffle: out[n, c, r*h+i, r*w+j] = in[n, c*r*r+i*r+j, h, w]
    (torch's ordering, which the JAX package reproduces in NHWC)."""
    return nn.functional.pixel_shuffle(x, r)


class Upsampler(nn.Module):
    """conv(C -> 4C, 3x3) + pixel shuffle, once per x2 factor."""

    def __init__(self, n_feats: int, scale: int = 2):
        super().__init__()
        assert scale & (scale - 1) == 0, "power-of-two scales only"
        self.n_ups = int(np.log2(scale))
        for i in range(self.n_ups):
            self.add_module(f"up{i}", conv(n_feats, 4 * n_feats, 3))

    def forward(self, x):
        for i in range(self.n_ups):
            x = pixel_shuffle(getattr(self, f"up{i}")(x), 2)
        return x


class StackedAtrousConvs(nn.Module):
    """Parallel dilated convs (rates 1,2,4) concatenated in rate order, then
    a 1x1 projection to the mixture parameters, in float32."""

    def __init__(self, rates: Sequence[int], Cin: int, Cout: int,
                 kernel_size: int = 3):
        super().__init__()
        self.rates = tuple(rates)
        for i, r in enumerate(self.rates):
            self.add_module(f"atrous{i}", conv(Cin, Cin, kernel_size, rate=r))
        self.lin = conv(len(self.rates) * Cin, Cout, 1)

    def forward(self, x):
        branches = [getattr(self, f"atrous{i}")(x)
                    for i in range(len(self.rates))]
        return self.lin(torch.cat(branches, dim=1).to(torch.float32))


def sub_rgb_mean(x: torch.Tensor) -> torch.Tensor:
    """x - 255*rgb_mean on an NHWC image."""
    return x - torch.as_tensor(255.0 * RGB_MEAN, dtype=x.dtype,
                               device=x.device)
