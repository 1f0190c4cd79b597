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

The RGB baselines (`rgb_bicubic_baseline`: cr_rgb, cr_rgb_shared) have no
heads, a parameter-free bicubic encoder per scale (the RGB pyramid) and C =
3 classifiers; `auto_recurse` applies the last scale's modules that many
more times (scale -1), as RGB Shared is evaluated.

Submodule names follow the flax tree (head0, enc0/block0/conv1, ...), so a
JAX checkpoint maps onto the state_dict by name (models/weights.py).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import MsConfig
from . import dmll, grids, layers, quantizer


def compute_dtype(cfg: MsConfig) -> Optional[torch.dtype]:
    """The conv stacks' compute dtype (the JAX package's `_cdtype`):
    bfloat16, or None for float32. Parameters are float32 either way."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


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
    """Per-scale encoder result. bn (the straight-through bottleneck:
    forward hard, gradient soft; None outside training), bn_q, syms and
    raw (the 1x1 conv's output before quantization) are NHWC float32; F is
    the pre-quantization feature in NCHW, in the compute dtype (internal:
    only the next scale's head reads it). The bicubic encoder has no F and
    no raw."""
    bn: Optional[torch.Tensor]
    bn_q: torch.Tensor
    syms: torch.Tensor
    F: Optional[torch.Tensor]
    raw: Optional[torch.Tensor]


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
        dt = compute_dtype(c)
        self.n_blocks = c.enc.num_blocks
        self.down = layers.conv(c.Cf, c.Cf, 5, stride=2, dtype=dt)
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", layers.ResBlock(c.Cf, c.kernel_size,
                                                         dt))
        self.body_out = layers.conv(c.Cf, c.Cf, c.kernel_size, dtype=dt)
        self.to_q = layers.conv(c.Cf, c.q.C, 1)      # float32: the bottleneck
        self.sigma = c.q.sigma
        lo, hi = c.q.levels_range
        self.register_buffer(
            "levels", torch.from_numpy(grids.levels(lo, hi, c.q.L)),
            persistent=False)

    def forward(self, x, train: bool = False) -> EncOut:
        x = self.down(x)
        r = x
        for i in range(self.n_blocks):
            r = getattr(self, f"block{i}")(r)
        F = x + self.body_out(r)
        raw = nhwc(self.to_q(F.to(torch.float32)))
        q = quantizer.quantize(raw, self.levels,
                               self.sigma if train else None)
        return EncOut(bn=q.bn, bn_q=q.bn_q, syms=q.syms, F=F, raw=raw)


class BicubicDownsamplingEnc(nn.Module):
    """The RGB baselines' encoder, without parameters: the image of the
    mean-subtracted NHWC input, rounded and clipped, downsampled x2 by
    Pillow's bicubic filter; its symbols are the downsampled pixels and its
    bottleneck (bn = bn_q) the same minus the mean, detached."""

    def forward(self, x) -> EncOut:
        mean = torch.as_tensor(255.0 * layers.RGB_MEAN, dtype=x.dtype,
                               device=x.device)
        img = torch.clamp(torch.round(x + mean), 0.0, 255.0)
        img_ds = layers.bicubic_downsample_x2(img)
        x_ds = layers.sub_rgb_mean(img_ds).detach()
        return EncOut(bn=x_ds, bn_q=x_ds, syms=img_ds.to(torch.int64),
                      F=None, raw=None)


class EDSRDec(nn.Module):
    """Upsampling decoder with an optional fused coarser feature."""

    def __init__(self, cfg: MsConfig, c_in: int):
        super().__init__()
        c = cfg
        dt = compute_dtype(c)
        self.n_blocks = c.dec.num_blocks
        self.head = layers.conv(c_in, c.Cf, 1, dtype=dt)
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", layers.ResBlock(c.Cf, c.kernel_size,
                                                         dt))
        self.body_out = layers.conv(c.Cf, c.Cf, c.kernel_size, dtype=dt)
        self.tail = layers.Upsampler(c.Cf, 2, dt)

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
        self.conv = layers.conv(c_in, cfg.Cf, cfg.kernel_size,
                                dtype=compute_dtype(cfg))

    def forward(self, x):
        return self.conv(x / 128.0 if self.rgb else x)


class AtrousProbabilityClassifier(nn.Module):
    """Decoder feature -> mixture parameters l (Kp channels)."""

    def __init__(self, cfg: MsConfig, C: int, rates=(1, 2, 4)):
        super().__init__()
        Kp = dmll.non_shared_get_Kp(cfg.prob.K, C)
        self.atrous = layers.StackedAtrousConvs(rates, cfg.Cf, Kp,
                                                cfg.kernel_size,
                                                compute_dtype(cfg))

    def forward(self, x):
        return self.atrous(x)


class MultiscaleNetwork(nn.Module):
    """The L3C model: heads + per-scale enc/dec + prob classifiers; for the
    RGB baselines bicubic encoders, no heads, C = 3 classifiers."""

    def __init__(self, cfg: MsConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        for s in range(c.num_scales):
            if c.rgb_bicubic_baseline:
                self.add_module(f"enc{s}", BicubicDownsamplingEnc())
            else:
                # scale 0 reads the image, scales >= 1 the previous
                # encoder's feature (feed_F) or its quantized bottleneck
                c_head = 3 if s == 0 else (c.Cf if c.enc.feed_F else c.q.C)
                self.add_module(f"head{s}", Head(c, c_head, rgb=(s == 0)))
                self.add_module(f"enc{s}", EDSRLikeEnc(c))
            self.add_module(f"dec{s}", EDSRDec(c, c.q.C))
            self.add_module(f"clf{s}", AtrousProbabilityClassifier(
                c, C=(3 if s == 0 or c.rgb_bicubic_baseline else c.q.C)))

    def _m(self, kind: str, scale: int) -> nn.Module:
        """The module of `scale`; -1 (a recursed scale) is the last one's."""
        return getattr(self, f"{kind}{scale % self.cfg.num_scales}")

    def forward_scales(self, auto_recurse: int = 0) -> List[int]:
        """The scales a forward runs, fine -> coarse: each of the config's,
        then -1 (the last scale's modules again) auto_recurse times."""
        return list(range(self.cfg.num_scales)) + [-1] * auto_recurse

    def enc_forward(self, x: torch.Tensor, train: bool = False,
                    auto_recurse: int = 0) -> List[EncOut]:
        """All encoders fine->coarse; `x` is the mean-subtracted NHWC image.
        With `train` each EncOut carries the straight-through `bn`."""
        enc_outs = []
        if self.cfg.rgb_bicubic_baseline:
            inp = x
            for scale in self.forward_scales(auto_recurse):
                enc_outs.append(self._m("enc", scale)(inp))
                inp = enc_outs[-1].bn
            return enc_outs
        inp = nchw(x)
        for scale in self.forward_scales(auto_recurse):
            eo = self._m("enc", scale)(self._m("head", scale)(inp), train)
            enc_outs.append(eo)
            inp = (eo.F if self.cfg.enc.feed_F else
                   nchw(eo.bn if train else eo.bn_q))
        return enc_outs

    def dec_forward(self, dec_inputs: List[torch.Tensor],
                    forward_scales: Optional[Sequence[int]] = None
                    ) -> List[torch.Tensor]:
        """Decoders coarse->fine with feature fusion; NHWC bottlenecks in,
        NCHW features out, fine->coarse. No feature is fused into the
        largest scale's decoder or a recursed one's."""
        if forward_scales is None:
            forward_scales = self.forward_scales()
        top = max(forward_scales)
        dec_Fs: List[torch.Tensor] = []
        for i, scale in reversed(list(enumerate(forward_scales))):
            fuse = (dec_Fs[0] if self.cfg.dec.skip and scale not in (-1, top)
                    else None)
            dec_Fs.insert(0, self._m("dec", scale)(nchw(dec_inputs[i]),
                                                   fuse))
        return dec_Fs

    def forward(self, x: torch.Tensor, train: bool = False,
                auto_recurse: int = 0) -> Out:
        """Full forward. `x`: NHWC float image in [0, 255]. With `train`
        the decoders read, and Out.bn holds, the straight-through
        bottlenecks (else the hard ones), and Out.P holds NHWC views of
        the classifier's NCHW output (the loss's K6 reads those planes
        where they lie; inference gets contiguous NHWC copies).
        auto_recurse: recursed scales after the config's (RGB Shared)."""
        img_syms = torch.round(x).to(torch.int64)
        xm = layers.sub_rgb_mean(x)
        if self.cfg.rgb_bicubic_baseline:
            xm = xm.detach()
        enc_outs = self.enc_forward(xm, train, auto_recurse)
        bns = [eo.bn if train else eo.bn_q for eo in enc_outs]
        scales = self.forward_scales(auto_recurse)
        dec_Fs = self.dec_forward(bns, scales)
        ls = [self._m("clf", s)(F) for s, F in zip(scales, dec_Fs)]
        Ps = tuple(l.permute(0, 2, 3, 1) if train else nhwc(l) for l in ls)
        S = (img_syms,) + tuple(eo.syms for eo in enc_outs)
        bn = (img_syms.to(torch.float32),) + tuple(bns)
        return Out(S=S, bn=bn, P=Ps)

    def sample_forward(self, x: torch.Tensor, generator: torch.Generator,
                       sample_scales: Sequence[int] = ()) -> torch.Tensor:
        """Generative sampling (the paper's Fig. 5): decoders coarse->fine,
        where a scale in `sample_scales` reads a SAMPLED bottleneck in
        place of its encoder's, and scale 0's RGB output is always sampled
        from its mixture. The coarsest sampled scale with nothing sampled
        above it reads uniform noise on the level grid. `x`: NHWC image in
        [0, 255]; draws from `generator` (on x's device). Returns the NHWC
        sample in [0, 255]."""
        cfg = self.cfg
        enc_outs = self.enc_forward(layers.sub_rgb_mean(x))
        rgb_spec = dmll.DMLLSpec(rgb_scale=True)
        lo, hi = cfg.q.levels_range
        bn_spec = (rgb_spec if cfg.rgb_bicubic_baseline else
                   dmll.DMLLSpec(rgb_scale=False, x_min=lo, x_max=hi,
                                 L=cfg.q.L))
        levels = torch.from_numpy(grids.levels(lo, hi, cfg.q.L)).to(x.device)
        prev, fuse = None, None
        for scale in reversed(range(cfg.num_scales)):
            if scale in sample_scales:
                if prev is None:
                    shape = enc_outs[-1].bn_q.shape
                    fake = -1.0 + 2.0 * torch.rand(
                        shape, generator=generator, device=x.device)
                    prev = quantizer.quantize(fake, levels).bn_q
                dec_inp = prev
            else:
                dec_inp = enc_outs[scale].bn_q
            l, F = self.get_P(scale, dec_inp, fuse)
            if cfg.dec.skip:
                fuse = F
            if scale == 0 or (scale - 1) in sample_scales:
                spec, C = ((rgb_spec, 3) if scale == 0 else
                           (bn_spec, cfg.q.C))
                prev = dmll.sample(spec, l, C, generator)
        return prev

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every conv's weights from `generator` with the JAX package's
        initializers (U(+-1/sqrt(fan_in)), zero biases), in place."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                layers.init_conv(m, generator)

    def get_P_nchw(self, scale: int, bn_q: torch.Tensor,
                   dec_F_prev: Optional[torch.Tensor] = None):
        """One decoder + classifier application for coding: NHWC bottleneck
        in, (l NCHW as the convolution wrote it, decoder feature NCHW)
        out. The coder's pack stage reads l in this layout."""
        if not 0 <= scale < self.cfg.num_scales:
            raise ValueError(f"scale {scale} of {self.cfg.num_scales}")
        F = self._m("dec", scale)(nchw(bn_q), dec_F_prev)
        return self._m("clf", scale)(F), F

    def get_P(self, scale: int, bn_q: torch.Tensor,
              dec_F_prev: Optional[torch.Tensor] = None):
        """get_P_nchw with l in the public layout: (l NHWC, decoder
        feature NCHW)."""
        l, F = self.get_P_nchw(scale, bn_q, dec_F_prev)
        return nhwc(l), F
