"""Building-block layers: same-padded convs, ResBlock, pixel-shuffle.

NCHW throughout (PyTorch's native layout, cuDNN's fast path). Conv
padding is `k//2` for plain convs and `rate` for dilated ones, matching
the reference's default_conv and the JAX package's explicit padding.

`dtype` is the convolutions' compute dtype, the JAX package's
`MsConfig.compute_dtype` (None: float32). Parameters stay float32 in
either case, so checkpoints do not depend on it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..data import resample

# RGB statistics used for input normalization (EDSR / DIV2K means; scaled
# by 255 at use sites).
RGB_MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with flax's `nn.Conv(dtype=...)` rounding points: with a
    compute dtype, the input, the kernel and the bias are cast to it, the
    convolution's output is rounded to it, and the bias is added in it
    (cuDNN and oneDNN would add it before rounding). Without one it is
    nn.Conv2d."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation)
        return y + self.bias.to(dt)[:, None, None]


def conv(cin: int, cout: int, kernel_size: int, stride: int = 1,
         rate: int = 1, dtype: Optional[torch.dtype] = None) -> Conv2d:
    """default_conv: same-pad (dilation-aware), OIHW weights, with bias,
    computing in `dtype` (None: float32). Initialised as the JAX package's
    flax convs: weights U(+-1/sqrt(fan_in)) (PyTorch's default, =
    variance_scaling(1/3, fan_in, uniform)), biases zero (flax's default;
    not PyTorch's U(+-1/sqrt(fan_in)))."""
    pad = kernel_size // 2 if rate == 1 else rate
    c = Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
               dilation=rate, dtype=dtype)
    nn.init.zeros_(c.bias)
    return c


def init_conv(c: nn.Conv2d, generator: torch.Generator) -> None:
    """Draw c's weights anew from `generator` (U(+-1/sqrt(fan_in))) and
    zero its bias, in place."""
    fan_in = c.weight.shape[1] * c.weight.shape[2] * c.weight.shape[3]
    bound = 1.0 / float(np.sqrt(fan_in))
    with torch.no_grad():
        c.weight.uniform_(-bound, bound, generator=generator)
        c.bias.zero_()


class ResBlock(nn.Module):
    """conv-ReLU-conv with identity skip."""

    def __init__(self, n_feats: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv(n_feats, n_feats, kernel_size, dtype=dtype)
        self.conv2 = conv(n_feats, n_feats, kernel_size, dtype=dtype)

    def forward(self, x):
        # in the compute dtype, as flax adds its bf16 output to x
        return x + self.conv2(torch.relu(self.conv1(x)))


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW pixel shuffle: out[n, c, r*h+i, r*w+j] = in[n, c*r*r+i*r+j, h, w]
    (torch's ordering, which the JAX package reproduces in NHWC)."""
    return nn.functional.pixel_shuffle(x, r)


class Upsampler(nn.Module):
    """conv(C -> 4C, 3x3) + pixel shuffle, once per x2 factor."""

    def __init__(self, n_feats: int, scale: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert scale & (scale - 1) == 0, "power-of-two scales only"
        self.n_ups = int(np.log2(scale))
        for i in range(self.n_ups):
            self.add_module(f"up{i}", conv(n_feats, 4 * n_feats, 3,
                                           dtype=dtype))

    def forward(self, x):
        for i in range(self.n_ups):
            x = pixel_shuffle(getattr(self, f"up{i}")(x), 2)
        return x


class StackedAtrousConvs(nn.Module):
    """Parallel dilated convs (rates 1,2,4) in the compute dtype,
    concatenated in rate order, then a 1x1 projection to the mixture
    parameters in float32 (the JAX package's, whatever the dtype)."""

    def __init__(self, rates: Sequence[int], Cin: int, Cout: int,
                 kernel_size: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.rates = tuple(rates)
        for i, r in enumerate(self.rates):
            self.add_module(f"atrous{i}", conv(Cin, Cin, kernel_size, rate=r,
                                               dtype=dtype))
        self.lin = conv(len(self.rates) * Cin, Cout, 1)

    def forward(self, x):
        branches = [getattr(self, f"atrous{i}")(x)
                    for i in range(len(self.rates))]
        return self.lin(torch.cat(branches, dim=1).to(torch.float32))


def sub_rgb_mean(x: torch.Tensor) -> torch.Tensor:
    """x - 255*rgb_mean on an NHWC image."""
    return x - torch.as_tensor(255.0 * RGB_MEAN, dtype=x.dtype,
                               device=x.device)


def bicubic_downsample_x2(x_rgb_0_255: torch.Tensor) -> torch.Tensor:
    """Bicubic x0.5 of an NHWC [0, 255] image (even H and W), as float32
    holding integers: Pillow's two-pass BICUBIC reduction bit for bit
    (data/resample), the pyramid the reference's RGB baselines were
    trained on."""
    _, H, W, _ = x_rgb_0_255.shape
    if H % 2 or W % 2:
        raise ValueError(f"bicubic x2 takes even extents, got {H}x{W}")
    x = torch.clamp(torch.round(x_rgb_0_255.to(torch.float32)), 0, 255
                    ).to(torch.int32)
    t = resample.resample_pass(x, 2, W // 2, "bicubic")   # Pillow's order
    return resample.resample_pass(t, 1, H // 2, "bicubic").to(torch.float32)
