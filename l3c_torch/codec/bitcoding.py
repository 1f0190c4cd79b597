"""The format-v1 codec: the network on the card, rANS on the host.

Port of `l3c_tpu/codec/bitcoding.py` (Bitcoding). Per scale, the device
runs get_P (decoder + classifier), `dmll.pack_coder_params` and the
(1,H,W,C,K) -> (C,HW,K) transpose; the packed (pi, mu, inv_s[, lam])
float32 arrays then go to the host, where the C++ backend
(ops/coder.py) codes all channels of the scale in one call, evaluating
the mixture CDFs itself and applying the RGB lambda chain from the
decoded symbols.

Determinism contract: encode computes every parameter through the SAME
get_P function decode uses (`_get_P`, never the training forward), under
`device.numerics_guard`, so both sides hand the backend bit-identical
floats; bottleneck values are rebuilt from symbols through the shared
level table (or, for the RGB baselines, the pixels minus the RGB mean).
The file does not record the compute dtype: a file decodes only with the
dtype (and device kind) that wrote it.

File format (the JAX package's, format byte 2):
  magic 'L3TP' | version u8 | num_scales u8 | n_chunks u8
  | CDF evaluator variant u8 | padL,padR,padT,padB u16*4
  | padded H u16 | W u16
  then per scale coarse->fine:
    [uniform coarsest]   n_chunks   * u32 chunk lengths | streams
    [mixture scales]   C*n_chunks   * u32 chunk lengths | streams
  each scale terminated by the magic separator u32 (checked on decode).
"""
from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import blueprint
from ..config import MsConfig
from ..device import DeviceLike, numerics_guard, resolve
from ..eval.timer import NoOpTimer
from ..models import dmll, grids, layers
from ..models.network import MultiscaleNetwork
from ..models.quantizer import levels_select
from ..ops import coder as coder_mod
from ..utils import pad as pad_mod
from . import auto_crop, part_suffix
from .bitcoding2 import DecodeError

MAGIC = b"L3TP"
MAGIC_SEP = 0x4C334353  # 'L3CS'
VERSION = 2  # the coding CDF pins edge 0 to 0 (lower-tail absorption)
# independent rANS chunks a channel that encode writes (the header records
# it: decode reads any count)
N_CHUNKS = coder_mod.DEFAULT_CHUNKS


class Bitcoding:
    """Encode/decode images with the host entropy backend (format v1)."""

    VERSION = VERSION

    def __init__(self, cfg: MsConfig, net: MultiscaleNetwork,
                 device: DeviceLike = None, times=None,
                 coder_profile: Optional[str] = None):
        """net: a MultiscaleNetwork with its weights loaded; it is moved to
        `device` (CUDA unless the caller passes "cpu").
        times: an eval.timer.StackTimer for the per-stage times: get_P
        (the device's work, synchronised), `to host` (the parameters'
        copy) and the host's entropy coder.
        coder_profile: accepted for the v8 codec's callers and ignored:
        v1 streams are chunked (N_CHUNKS a channel), not split by
        length."""
        self.device = resolve(device)
        numerics_guard()
        self.cfg = cfg
        self.net = net.to(self.device).eval()
        self.times = times if times is not None else NoOpTimer()
        self._rgb = blueprint.rgb_spec(cfg)
        self._bn = blueprint.bn_spec(cfg)
        lo, hi = cfg.q.levels_range
        self._bn_levels = torch.from_numpy(
            grids.levels(lo, hi, cfg.q.L)).to(self.device)
        # per file of the last encode, per unit (scale): bytes on disk
        # (chunk lengths + streams); unit_scale_map() labels them
        self.last_unit_bytes: List[List[int]] = []

    # ------------------------------------------------- the shared get_P

    def _spec_at(self, scale: int):
        """(spec, channels) of the mixture coding `scale`'s target."""
        if scale == 0 or self.cfg.rgb_bicubic_baseline:
            return self._rgb, 3
        return self._bn, self.cfg.q.C

    def _get_P(self, scale: int, bn_q: torch.Tensor,
               dec_F: Optional[torch.Tensor]):
        """One decoder + classifier application, the coder's parameters
        packed and laid out (C, HW, K) on the device: the function both
        codec sides run. Returns (decoder feature, (pi, mu, inv_s, lam))."""
        l, F = self.net.get_P(scale, bn_q, dec_F)
        return F, self.pack(scale, l)

    def pack(self, scale: int, l: torch.Tensor):
        """The classifier's NHWC output `l` (one image) -> (pi, mu, inv_s,
        lam) as the backend reads them: dmll.pack_coder_params, then each
        (1,H,W,C,K) -> (C,HW,K), contiguous; lam is None off scale 0."""
        spec, C = self._spec_at(scale)

        def to_chwk(a):
            _, H, W, Cc, K = a.shape
            return a.reshape(H * W, Cc, K).transpose(0, 1).contiguous()
        return tuple(None if a is None else to_chwk(a)
                     for a in dmll.pack_coder_params(spec, l, C))

    def _params(self, scale: int, bn_q, dec_F):
        """_get_P timed on the device, then its arrays on the host."""
        with self.times.run("get_P"):
            F, packed = self._get_P(scale, bn_q, dec_F)
        with self.times.run("to host"):
            host = [None if a is None else a.cpu().numpy() for a in packed]
        return F, host

    def _bn_of_syms(self, syms_chw: np.ndarray) -> torch.Tensor:
        """Decoded (C,h,w) symbols -> the (1,h,w,C) float32 conditioning
        input on the device: the level table's values for an L3C
        bottleneck, the pixels minus the RGB mean for a bicubic pyramid
        (BicubicDownsamplingEnc's output)."""
        nhwc = torch.from_numpy(np.ascontiguousarray(
            syms_chw.transpose(1, 2, 0)[None])).to(self.device)
        if self.cfg.rgb_bicubic_baseline:
            return layers.sub_rgb_mean(nhwc.to(torch.float32)).contiguous()
        return levels_select(self._bn_levels, nhwc.to(torch.int64))

    def _mixture_coder(self, scale: int, n_chunks: int):
        spec, _ = self._spec_at(scale)
        return coder_mod.MixtureCoder(spec.L, spec.x_min, spec.x_max,
                                      n_chunks)

    def _uniform_unit(self) -> Tuple[int, int]:
        """(channels, L) of the coarsest unit: the bottleneck, or the
        baselines' coarsest downsampled image."""
        if self.cfg.rgb_bicubic_baseline:
            return 3, self._rgb.L
        return self.cfg.q.C, self._bn.L

    def unit_scale_map(self) -> List[str]:
        """The scale each file unit codes, aligned with last_unit_bytes:
        ['uniform', 'scale_{S-1}', ..., 'scale_0']."""
        return ["uniform"] + [f"scale_{s}" for s in
                              reversed(range(self.cfg.num_scales))]

    # ------------------------------------------------------------ encode

    def encode(self, img: np.ndarray, pout: str) -> float:
        """Encode a uint8 (H,W,3) or (1,H,W,3) image to `pout` (big ones
        auto-cropped into .partN files); returns its bpsp."""
        if img.ndim == 3:
            img = img[None]
        if img.ndim != 4 or img.shape[0] != 1 or img.shape[3] != 3:
            raise ValueError(f"expected one (1,H,W,3) image, got {img.shape}")
        if os.path.isfile(pout):
            raise FileExistsError(pout)
        if auto_crop.needs_crop(img):
            comb = auto_crop.CropLossCombinator()
            unit_sums: List[int] = []
            for i, crop in enumerate(auto_crop.iter_crops(img)):
                bpsp = self.encode(crop,
                                   pout + part_suffix.make_part_suffix(i))
                comb.add(bpsp, int(np.prod(crop.shape[1:3])))
                part = self.last_unit_bytes[0]
                unit_sums = [a + b for a, b in
                             zip(unit_sums or [0] * len(part), part)]
            self.last_unit_bytes = [unit_sums]
            return comb.get_bpsp()

        padded, pad_tuple = pad_mod.pad(np.asarray(img),
                                        self.cfg.padding_fac, "constant")
        _, H, W, _ = padded.shape
        S, times, n_chunks = self.cfg.num_scales, self.times, N_CHUNKS
        unit_bytes: List[int] = []
        with torch.inference_mode():
            with times.run("[-] encode forwardpass"):
                x = torch.from_numpy(padded).to(self.device).to(
                    torch.float32)
                per_scale = self.net.enc_forward(layers.sub_rgb_mean(x))
                syms = [_to_chw(eo.syms.cpu().numpy()) for eo in per_scale]
            with open(pout, "wb") as fout:
                fout.write(MAGIC)
                fout.write(struct.pack("<BBBB", VERSION, S, n_chunks,
                                       coder_mod.eval_variant()))
                fout.write(struct.pack("<4H", *pad_tuple))
                fout.write(struct.pack("<HH", H, W))
                _, uni_L = self._uniform_unit()
                with times.prefix_scope(f"[{S}]"):
                    with times.run("uniform encode"):
                        data, lens = coder_mod.UniformCoder(
                            uni_L, n_chunks).encode(syms[S - 1])
                    unit_bytes.append(_write_scale(fout, lens, data))
                dec_F, bn_prev = None, per_scale[S - 1].bn_q
                for scale in reversed(range(S)):
                    with times.prefix_scope(f"[{scale}]"):
                        dec_F, (pi, mu, inv_s, lam) = self._params(
                            scale, bn_prev, dec_F)
                        if scale == 0:
                            target = _to_chw(padded)
                        else:
                            target = syms[scale - 1]
                            bn_prev = per_scale[scale - 1].bn_q
                        with times.run("entropy encode"):
                            data, lens = self._mixture_coder(
                                scale, n_chunks).encode(
                                    pi, mu, inv_s, lam,
                                    target.reshape(target.shape[0], -1))
                        unit_bytes.append(_write_scale(fout, lens, data))
        self.last_unit_bytes = [unit_bytes]
        # bpsp over the ORIGINAL (pre-pad) subpixels
        return os.path.getsize(pout) * 8 / float(np.prod(img.shape))

    # ------------------------------------------------------------ decode

    def decode(self, pin: str, _recurse_part: bool = True) -> np.ndarray:
        """Decode `pin` (or its .partN set) to a (1,H,W,3) uint8 image."""
        if _recurse_part and part_suffix.contains_part_suffix(pin):
            parts = [self.decode(p, _recurse_part=False)
                     for p in part_suffix.iter_part_paths(pin)]
            return auto_crop.stitch(parts)
        S, times = self.cfg.num_scales, self.times
        with open(pin, "rb") as fin, torch.inference_mode():
            if fin.read(4) != MAGIC:
                raise DecodeError("bad magic")
            version, S_f, n_chunks, ev = struct.unpack("<BBBB", fin.read(4))
            if version != VERSION:
                raise DecodeError(f"unsupported version {version}")
            if ev != coder_mod.eval_variant():
                raise DecodeError(
                    f"file was encoded with CDF evaluator variant {ev}; "
                    f"this backend implements variant "
                    f"{coder_mod.eval_variant()}: decoding would corrupt "
                    f"symbols")
            if S_f != S:
                raise DecodeError(f"stream has {S_f} scales, model {S}")
            pad_tuple = struct.unpack("<4H", fin.read(8))
            H, W = struct.unpack("<HH", fin.read(4))
            C_u, uni_L = self._uniform_unit()
            h, w = H >> S, W >> S
            with times.prefix_scope(f"[{S}]"):
                with times.run("uniform decode"):
                    lens, data = _read_scale(fin, n_chunks)
                    syms = coder_mod.UniformCoder(uni_L, n_chunks).decode(
                        data, lens, C_u * h * w).reshape(C_u, h, w)
            bn_prev, dec_F, img = self._bn_of_syms(syms), None, None
            for scale in reversed(range(S)):
                with times.prefix_scope(f"[{scale}]"):
                    dec_F, (pi, mu, inv_s, lam) = self._params(
                        scale, bn_prev, dec_F)
                    hs, ws = H >> scale, W >> scale
                    C = pi.shape[0]
                    with times.run("entropy decode"):
                        lens, data = _read_scale(fin, C * n_chunks)
                        syms = self._mixture_coder(scale, n_chunks).decode(
                            pi, mu, inv_s, lam, data, lens)
                    syms = syms.reshape(C, hs, ws)
                    if scale == 0:
                        img = syms.transpose(1, 2, 0)
                    else:
                        bn_prev = self._bn_of_syms(syms)
        img = img[None].astype(np.uint8)
        if any(pad_tuple):
            img = pad_mod.undo_pad(img, *pad_tuple)
        return img


# ------------------------------------------------------------------ helpers


def _to_chw(a: np.ndarray) -> np.ndarray:
    """(1,H,W,C) -> (C,H,W) int32 contiguous."""
    return np.ascontiguousarray(
        np.asarray(a)[0].transpose(2, 0, 1).astype(np.int32))


def _write_scale(fout, chunk_lens, data: bytes) -> int:
    """One scale's chunk lengths, streams and separator; returns the bytes
    of the lengths and streams."""
    lens = np.asarray(chunk_lens).reshape(-1)
    fout.write(lens.astype("<u4").tobytes())
    fout.write(data)
    fout.write(struct.pack("<I", MAGIC_SEP))
    return 4 * lens.size + len(data)


def _read_scale(fin, n_lens: int) -> Tuple[np.ndarray, bytes]:
    raw = fin.read(4 * n_lens)
    if len(raw) != 4 * n_lens:
        raise DecodeError("truncated stream")
    lens = np.frombuffer(raw, "<u4").astype(np.int64)
    data = fin.read(int(lens.sum()))
    sep = fin.read(4)
    if len(data) != int(lens.sum()) or len(sep) != 4 or \
            struct.unpack("<I", sep)[0] != MAGIC_SEP:
        raise DecodeError("magic separator mismatch: corrupt stream")
    return lens, data
