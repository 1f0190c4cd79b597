"""The multiscale L3C network as one nn.Module.

Port of `l3c_tpu/models/network.py` (reference multiscale_network.py,
net.py, head.py, prob_clf.py). NCHW inside; the public tensors (`Out`,
`EncOut.bn_q/syms`, `get_P`'s mixture parameters) are NHWC, the JAX
package's layout, so the DMLL, the blueprint and the codec read them
the same way in both packages.

Structure per scale s:
  head:  conv(k=3) -> Cf channels (RGB scale: x/128 first)
  enc:   conv5x5/s2 -> ResBlocks + skip -> 1x1 -> C -> quantizer
  dec:   1x1 C->Cf -> [+ fused coarser feature] -> ResBlocks + skip
         -> conv + pixel-shuffle x2
  clf:   3 dilated convs (1,2,4) concat -> 1x1 -> Kp

Submodule names follow the flax tree (head0, enc0/block0/conv1, ...), so a
JAX checkpoint maps onto the state_dict by name (models/weights.py).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import MsConfig
from . import dmll, grids, layers, quantizer


# Both layout changes COPY into a contiguous tensor: a permuted view would
# hand the convolutions channels-last strides on one codec side and plain
# NCHW on the other, and the backend may pick different algorithms (and
# round differently) for the two — breaking the encode/decode float
# contract without any error.
def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class EncOut(NamedTuple):
    """Per-scale encoder result. bn_q/syms NHWC; F is the pre-quantization
    feature in NCHW (internal: only the next scale's head reads it)."""
    bn_q: torch.Tensor
    syms: torch.Tensor
    F: torch.Tensor


class Out(NamedTuple):
    """Network output, tuples fine->coarse, NHWC. S[0] is the int image,
    S[i>=1] the bottleneck symbols; P[i] parameterizes the mixture that
    predicts scale i's target; bn[0] is the float image."""
    S: Tuple[torch.Tensor, ...]
    bn: Tuple[torch.Tensor, ...]
    P: Tuple[torch.Tensor, ...]


class EDSRLikeEnc(nn.Module):
    """Strided downsampling encoder + quantizer."""

    def __init__(self, cfg: MsConfig):
        super().__init__()
        c = cfg
        self.n_blocks = c.enc.num_blocks
        self.down = layers.conv(c.Cf, c.Cf, 5, stride=2)
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", layers.ResBlock(c.Cf, c.kernel_size))
        self.body_out = layers.conv(c.Cf, c.Cf, c.kernel_size)
        self.to_q = layers.conv(c.Cf, c.q.C, 1)
        lo, hi = c.q.levels_range
        self.register_buffer(
            "levels", torch.from_numpy(grids.levels(lo, hi, c.q.L)),
            persistent=False)

    def forward(self, x) -> EncOut:
        x = self.down(x)
        r = x
        for i in range(self.n_blocks):
            r = getattr(self, f"block{i}")(r)
        F = x + self.body_out(r)
        q = quantizer.quantize(nhwc(self.to_q(F)), self.levels)
        return EncOut(bn_q=q.bn_q, syms=q.syms, F=F)


class EDSRDec(nn.Module):
    """Upsampling decoder with an optional fused coarser feature."""

    def __init__(self, cfg: MsConfig, c_in: int):
        super().__init__()
        c = cfg
        self.n_blocks = c.dec.num_blocks
        self.head = layers.conv(c_in, c.Cf, 1)
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", layers.ResBlock(c.Cf, c.kernel_size))
        self.body_out = layers.conv(c.Cf, c.Cf, c.kernel_size)
        self.tail = layers.Upsampler(c.Cf, 2)

    def forward(self, x, features_to_fuse=None):
        x = self.head(x)
        if features_to_fuse is not None:
            x = x + features_to_fuse
        r = x
        for i in range(self.n_blocks):
            r = getattr(self, f"block{i}")(r)
        return self.tail(x + self.body_out(r))


class Head(nn.Module):
    """Cin -> Cf conv; the RGB head divides by 128 first."""

    def __init__(self, cfg: MsConfig, c_in: int, rgb: bool):
        super().__init__()
        self.rgb = rgb
        self.conv = layers.conv(c_in, cfg.Cf, cfg.kernel_size)

    def forward(self, x):
        return self.conv(x / 128.0 if self.rgb else x)


class AtrousProbabilityClassifier(nn.Module):
    """Decoder feature -> mixture parameters l (Kp channels)."""

    def __init__(self, cfg: MsConfig, C: int, rates=(1, 2, 4)):
        super().__init__()
        Kp = dmll.non_shared_get_Kp(cfg.prob.K, C)
        self.atrous = layers.StackedAtrousConvs(rates, cfg.Cf, Kp,
                                                cfg.kernel_size)

    def forward(self, x):
        return self.atrous(x)


class MultiscaleNetwork(nn.Module):
    """The L3C model: heads + per-scale enc/dec + prob classifiers."""

    def __init__(self, cfg: MsConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        for s in range(c.num_scales):
            # scale 0 reads the image, scales >= 1 the previous encoder's
            # feature (feed_F) or its quantized bottleneck
            c_head = 3 if s == 0 else (c.Cf if c.enc.feed_F else c.q.C)
            self.add_module(f"head{s}", Head(c, c_head, rgb=(s == 0)))
            self.add_module(f"enc{s}", EDSRLikeEnc(c))
            self.add_module(f"dec{s}", EDSRDec(c, c.q.C))
            self.add_module(f"clf{s}", AtrousProbabilityClassifier(
                c, C=(3 if s == 0 else c.q.C)))

    def _m(self, kind: str, scale: int) -> nn.Module:
        return getattr(self, f"{kind}{scale}")

    def enc_forward(self, x: torch.Tensor) -> List[EncOut]:
        """All encoders fine->coarse; `x` is the mean-subtracted NHWC image."""
        enc_outs = []
        inp = nchw(x)
        for scale in range(self.cfg.num_scales):
            eo = self._m("enc", scale)(self._m("head", scale)(inp))
            enc_outs.append(eo)
            inp = eo.F if self.cfg.enc.feed_F else nchw(eo.bn_q)
        return enc_outs

    def dec_forward(self, dec_inputs: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Decoders coarse->fine with feature fusion; NHWC bottlenecks in,
        NCHW features out, fine->coarse."""
        S = self.cfg.num_scales
        dec_Fs: List[torch.Tensor] = []
        for scale in reversed(range(S)):
            fuse = dec_Fs[0] if (self.cfg.dec.skip and scale != S - 1) \
                else None
            dec_Fs.insert(0, self._m("dec", scale)(nchw(dec_inputs[scale]),
                                                   fuse))
        return dec_Fs

    def forward(self, x: torch.Tensor) -> Out:
        """Full inference forward. `x`: NHWC float image in [0, 255]."""
        img_syms = torch.round(x).to(torch.int64)
        enc_outs = self.enc_forward(layers.sub_rgb_mean(x))
        dec_Fs = self.dec_forward([eo.bn_q for eo in enc_outs])
        Ps = tuple(nhwc(self._m("clf", s)(F)) for s, F in enumerate(dec_Fs))
        S = (img_syms,) + tuple(eo.syms for eo in enc_outs)
        bn = (img_syms.to(torch.float32),) + tuple(eo.bn_q for eo in enc_outs)
        return Out(S=S, bn=bn, P=Ps)

    def get_P(self, scale: int, bn_q: torch.Tensor,
              dec_F_prev: Optional[torch.Tensor] = None):
        """One decoder + classifier application for coding: NHWC bottleneck
        in, (l NHWC, decoder feature NCHW) out."""
        assert 0 <= scale < self.cfg.num_scales
        F = self._m("dec", scale)(nchw(bn_q), dec_F_prev)
        return nhwc(self._m("clf", scale)(F)), F
