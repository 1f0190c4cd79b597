"""The format-v8 codec on the card: network, coding CDFs and rANS on device.

Port of `l3c_tpu/codec/bitcoding2.py` (TpuBitcoding). Files are
byte-compatible with the JAX package's v8 files; whether one package
decodes the other's files is decided by the header canary (below).

Determinism contract (v4): every FLOAT-producing stage — the get_P network
application and pack_int_params — runs at a FIXED PHYSICAL BATCH `fbatch`
recorded in the header, with the same device settings on both sides
(device.numerics_guard: TF32 off, deterministic cuDNN, no autotuning).
Within one such configuration no operator mixes batch slots, so a file
encoded in any slot decodes bit-exactly in any slot. Logical batches
smaller than fbatch are padded by repeating image 0 (encode) / file 0
(decode). Everything downstream of pack_int_params is exact-integer math
(ops/int_coder.py), identical in any program shape.

Host and device overlap as in the JAX package: encode_batch_async,
decode_batch_async and verify_batch_async dispatch a batch's device work
on PyTorch's current stream and return a handle without waiting for the
card; their _finish halves make the one fetch and the host's file work.
Uploads go through pinned buffers (non_blocking), and an encode's lengths
and words leave the card in one non_blocking copy into pinned memory
behind an event. Dispatching batch i + 1 (or a decode) before finishing
batch i keeps the card busy while the host writes or parses files; the
bytes are those of the one-after-the-other order.

Scale coding structure (per image, one file "unit" each):
  unit 0:            coarsest bottleneck, uniform prior, all channels
  per scale coarse->fine:
    bn scales:       ONE unit, all q.C channels, 2-edge lookups on encode,
                     full rows on decode
    RGB scale 0:     TWO units (two-level coding): 16-ary coarse symbols,
                     then 16-ary fine symbols conditional on the coarse bin;
                     decode runs channel by channel through the lambda chain
  The RGB baselines code every scale as scale 0 (two units each) and their
  unit 0 is the coarsest downsampled image under the uniform prior over
  L = 256; the next decoder reads a decoded scale's pixels minus the RGB
  mean, as the encoder's bicubic pyramid hands it.

File format v8:
  magic 'L3TP' | version=8 u8 | num_scales u8 | fbatch u8
  | topk u8 (0 = full mixture) | canary u32
  | padL,padR,padT,padB u16*4 | padded H u16 | W u16
  per unit: T u16 | n_streams u32
            | length block (mode u8: 0 = base u16 + u8 deltas,
                            1 = raw u16 lengths)
            | words u16[] | magic separator u32.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import blueprint
from ..config import MsConfig
from ..device import DeviceLike, numerics_guard, resolve
from ..eval.timer import NoOpTimer
from ..models import dmll as dmll_mod
from ..models import grids, layers
from ..models.network import MultiscaleNetwork
from ..models.quantizer import levels_select
from ..ops import float_cdf
from ..ops import gpu_coder as gc
from ..ops import int_coder as ic
from ..ops import kernels
from ..utils import pad as pad_mod
from . import auto_crop, part_suffix

MAGIC = b"L3TP"
MAGIC_SEP = 0x4C334353  # 'L3CS'
FINE_BITS = 4

# Allowed physical float-batch sizes; encode picks the smallest >= the
# logical batch.
FBATCHES = (1, 2, 4, 8, 16, 32)


class DecodeError(Exception):
    pass


def fbatch_for(B: int) -> int:
    for f in FBATCHES:
        if f >= B:
            return f
    raise ValueError(f"logical batch {B} > max fbatch {FBATCHES[-1]}; "
                     f"chunk the batch into groups of {FBATCHES[-1]}")


def _group_syms(nhwc: torch.Tensor) -> torch.Tensor:
    """(F,h,w,C) -> (C*F*n,) channel-major / batch-minor."""
    return nhwc.permute(3, 0, 1, 2).reshape(-1)


def _ungroup_syms(flat_gn: torch.Tensor, F: int, h: int, w: int
                  ) -> torch.Tensor:
    """(C*F, n) -> (F,h,w,C)."""
    C = flat_gn.shape[0] // F
    return flat_gn.reshape(C, F, h, w).permute(1, 2, 3, 0)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on the card through a pinned buffer,
    non_blocking on the current stream (PyTorch's pinned-memory cache
    keeps the buffer until the copy has run), so the host goes on."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch_async(parts: Sequence[Tuple[torch.Tensor, bool]]) -> dict:
    """Start one device-to-host copy of (int32 tensor, wide) parts holding
    u16 values (words) or, wide, int32 ones (lengths): flattened into one
    int16 buffer on the device, copied non_blocking into pinned memory on
    the current stream, an event recorded behind it. _fetch_finish
    waits."""
    flat = torch.cat([p.reshape(-1).view(torch.int16) if wide
                      else p.reshape(-1).to(torch.int16)
                      for p, wide in parts])
    shapes = [(tuple(p.shape), wide) for p, wide in parts]
    if flat.device.type != "cuda":
        return dict(host=flat, event=None, shapes=shapes)
    host = torch.empty(flat.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return dict(host=host, event=event, shapes=shapes, src=flat)


def _fetch_finish(fetch: dict) -> List[np.ndarray]:
    """The arrays of _fetch_async, once its copy has run: int32 for the
    wide parts, uint16 for the words."""
    if fetch["event"] is not None:
        fetch["event"].synchronize()
    flat = fetch["host"].numpy()
    out, off = [], 0
    for shape, wide in fetch["shapes"]:
        n = int(np.prod(shape)) * (2 if wide else 1)
        part = flat[off:off + n]
        off += n
        out.append(part.view(np.int32).reshape(shape) if wide else
                   part.view(np.uint16).reshape(shape))
    return out


def pack_int(spec: dmll_mod.DMLLSpec, l: torch.Tensor, C: int, topk: int
             ) -> ic.IntParams:
    """The coder's float pack stage on the classifier's output l
    (N,Kp,H,W) as the convolution wrote it: the pack_int kernel for a
    tensor on the card, int_coder.pack_int_params_nchw for one on the
    CPU. The one function both codec sides and the header canary pack
    with."""
    if l.is_cuda:
        return ic.IntParams(*kernels.pack_int(
            l.contiguous(), C, topk, spec.rgb_scale, spec.bin_width,
            spec.x_min - spec.bin_width / 2.0))
    return ic.pack_int_params_nchw(spec, l, C, topk)


def canary_inputs(bn_spec, C_bn: int, K: int):
    """The canary's fixed synthetic network outputs and targets (128
    pixels): (l_rgb, l_bn, t_rgb, t_bn) numpy arrays, the JAX package's."""
    n_h, n_w = 4, 32
    rs = np.random.RandomState(0x13C7)
    Kp_rgb = dmll_mod.non_shared_get_Kp(K, 3)
    Kp_bn = dmll_mod.non_shared_get_Kp(K, C_bn)
    l_rgb = (rs.randn(1, n_h, n_w, Kp_rgb) * 2.0).astype(np.float32)
    l_bn = (rs.randn(1, n_h, n_w, Kp_bn) * 2.0).astype(np.float32)
    t_rgb = rs.randint(0, 256, (1, n_h, n_w, 3)).astype(np.int32)
    t_bn = rs.randint(0, bn_spec.L, (C_bn, n_h * n_w)).astype(np.int32)
    return l_rgb, l_bn, t_rgb, t_bn


def canary_leaves(ip_r: ic.IntParams, ip_b: ic.IntParams,
                  t_rgb: torch.Tensor, t_bn: torch.Tensor, bn_L: int):
    """The integer half of the canary chain — decode rows and encode
    2-edge lookups, RGB channel 1 and all bn channels — as
    (tensor, JAX dtype) leaves in the JAX package's order."""
    C_bn = ip_b.p.shape[0]
    t = t_rgb.to(torch.int64)
    a1 = (t[..., 1] >> FINE_BITS).reshape(-1)
    b1 = (t[..., 1] & 15).reshape(-1)
    dec1 = (t[..., 0].reshape(-1),)
    rows = [ic.rgb_coarse_rows(ip_r, 1, dec1),
            ic.rgb_fine_rows(ip_r, 1, dec1, a1)]
    look = [*ic.rgb_coarse_lookup(ip_r, 1, dec1, a1),
            *ic.rgb_fine_lookup(ip_r, 1, dec1, a1, b1)]
    bn_rows = ic.bn_rows(ip_b, C_bn, bn_L)
    bn_look = ic.bn_lookup(ip_b, t_bn.to(torch.int64), C_bn, bn_L)
    return ([(r, np.uint16) for r in rows] + [(x, np.uint32) for x in look]
            + [(bn_rows, np.uint16)] + [(x, np.uint32) for x in bn_look])


def coder_check(ip_r: ic.IntParams, ip_b: ic.IntParams, bn_L: int,
                T: int = 256) -> None:
    """Hold the coder's channel-level functions to their plain versions
    on the canary's IntParams, at every symbol value of every pixel: the
    encodes' lengths and used words identical, the decodes recovering the
    symbols. On the card the coder is the rANS kernels, whose own CDF
    evaluation (csrc/int_cdf.cuh) the canary's int_coder leaves do not
    run; this ties it to them. Raises RuntimeError where they differ."""
    dev = ip_b.p.device
    n = ip_b.p.shape[2]

    def tiled(ip, V):      # every pixel's parameters V times along N
        return ic.IntParams(*[None if x is None else
                              x.repeat(1, 1, V).contiguous() for x in ip])

    def same(got, want):
        (wk, lk), (wp, lp) = got, want
        used = lambda w, ln: w[torch.arange(w.shape[1], device=dev)[None]
                               < ln[:, None]]
        return torch.equal(lk, lp) and torch.equal(used(wk, lk),
                                                   used(wp, lp))

    def cut(w, ln):
        return w[:, :int(ln.max())].contiguous()

    bad = []
    # RGB: pixel block v codes value (2c + 1) v + 37 c of channel c, a
    # bijection of 0..255 per channel, so the lambda chain varies
    v = torch.arange(256, device=dev).repeat_interleave(n)
    img = torch.stack([((2 * c + 1) * v + 37 * c) % 256 for c in range(3)])
    ip = tiled(ip_r, 256)
    lay6 = gc.layout_for(img.shape[1], 6, T)
    w6, l6 = gc.encode_rgb(ip, img, lay6)
    if not same((w6, l6), gc.encode_rgb_plain(ip, img, lay6)):
        bad.append("encode_rgb")
    lay = gc.layout_for(img.shape[1], 1, T)
    ns, planes = lay.ns_c, img.to(torch.uint8)
    for c in range(3):
        rc, rf = slice(c * ns, (c + 1) * ns), slice((3 + c) * ns,
                                                    (4 + c) * ns)
        a = gc.decode_rgb_coarse(ip, c, planes, cut(w6[rc], l6[rc]), lay)
        b = gc.decode_rgb_fine(ip, c, planes, a, cut(w6[rf], l6[rf]), lay)
        if not torch.equal((a.long() << 4) | b.long(), img[c]):
            bad.append(f"decode_rgb channel {c}")
    # bn: every channel codes value v at pixel block v
    C_bn = ip_b.p.shape[0]
    syms = torch.arange(bn_L, device=dev).repeat_interleave(n)
    syms = syms[None].expand(C_bn, -1).contiguous()
    ip = tiled(ip_b, bn_L)
    lay = gc.layout_for(syms.shape[1], C_bn, T)
    coded = gc.encode_bn(ip, syms, bn_L, lay)
    if not same(coded, gc.encode_bn_plain(ip, syms, bn_L, lay)):
        bad.append("encode_bn")
    if not torch.equal(gc.decode_bn(ip, cut(*coded), bn_L, lay).long(),
                       syms):
        bad.append("decode_bn")
    if bad:
        raise RuntimeError(f"the coder differs from its plain version on "
                           f"the canary's inputs: {', '.join(bad)}")


def contract_canary(rgb_spec, bn_spec, C_bn: int, K: int, topk: int,
                    device: torch.device) -> int:
    """u32 attestation that THIS process produces the coder numerics the
    encoder's did: the v8 chain (the float pack stage, then decode rows
    and encode 2-edge lookups, bn and two-level RGB) on fixed synthetic
    network outputs, CRC32'd. The inputs, the chain and the byte layout are
    the JAX package's, so the canaries agree exactly when both packages'
    float pack rounds the same way. The pack is `pack_int`, the function
    the codec runs (on the card the pack_int kernel), and on the card the
    coder kernels are first held to the chain's int_coder on the same
    IntParams (coder_check), so the canary attests them too."""
    l_rgb, l_bn, t_rgb, t_bn = canary_inputs(bn_spec, C_bn, K)

    def dev(a):
        return torch.from_numpy(a).to(device)

    def planes(l_nhwc):          # the layout the classifier writes
        return dev(l_nhwc).permute(0, 3, 1, 2).contiguous()

    with torch.inference_mode():
        ip_r = pack_int(rgb_spec, planes(l_rgb), 3, topk)
        ip_b = pack_int(bn_spec, planes(l_bn), C_bn, topk)
        if ip_b.p.is_cuda:
            coder_check(ip_r, ip_b, bn_spec.L)
        leaves = canary_leaves(ip_r, ip_b, dev(t_rgb), dev(t_bn), bn_spec.L)
    blob = b"".join(x.cpu().numpy().astype(dt).tobytes() for x, dt in leaves)
    return zlib.crc32(blob) & 0xFFFFFFFF


class TorchBitcoding:
    """Encode/decode images with the on-device coder (format v8)."""

    VERSION = 8

    def __init__(self, cfg: MsConfig, net: MultiscaleNetwork,
                 device: DeviceLike = None,
                 coder_profile: Optional[str] = None,
                 coder_topk: Optional[int] = None, times=None):
        """net: a MultiscaleNetwork with its weights loaded; it is moved to
        `device` (CUDA unless the caller passes "cpu").
        times: an eval.timer.StackTimer that receives the per-stage times
        (its scopes synchronize with the card); none are taken without.
        coder_profile: speed|balanced|size stream-length policy
        (ops/gpu_coder.t_policy), balanced by default.
        coder_topk: code with the top-k mixture components (renormalized);
        default 4 for the speed/balanced profiles and 0 (full mixture) for
        size. Recorded in the header, so any topk decodes."""
        self.device = resolve(device)
        numerics_guard()
        self.cfg = cfg
        self.net = net.to(self.device).eval()
        self.coder_profile = coder_profile or gc.DEFAULT_PROFILE
        if coder_topk is None:
            coder_topk = 0 if self.coder_profile == "size" else 4
        self.coder_topk = int(coder_topk)
        self._rgb = blueprint.rgb_spec(cfg)
        self._bn = blueprint.bn_spec(cfg)
        lo, hi = cfg.q.levels_range
        self._bn_levels = torch.from_numpy(
            grids.levels(lo, hi, cfg.q.L)).to(self.device)
        self._canaries: Dict[int, int] = {}
        self.times = times if times is not None else NoOpTimer()
        # per file of the last encode_batch, per unit: bytes on disk
        # (streams + framing, without the separator); unit_scale_map()
        # labels the units
        self.last_unit_bytes: List[List[int]] = []
        # filled by decode_batch(float_rows=True): the scale-0 v7 float
        # rows of the last decoded batch and the inputs they came from
        self.last_float_rows: Optional[dict] = None

    def canary(self, topk: int) -> int:
        if topk not in self._canaries:
            self._canaries[topk] = contract_canary(
                self._rgb, self._bn, self.cfg.q.C, self.cfg.prob.K, topk,
                self.device)
        return self._canaries[topk]

    def _get_P_int(self, scale: int, topk: int, bn, dec_F):
        """get_P + pack_int: the codec's only float stage, shared by
        encode and decode. The classifier's NCHW output goes to the pack
        as it lies. Returns (IntParams, decoder feature, l NCHW)."""
        l, F = self.net.get_P_nchw(scale, bn, dec_F)
        spec, C = ((self._rgb, 3) if self._rgb_at(scale) else
                   (self._bn, self.cfg.q.C))
        return pack_int(spec, l, C, topk), F, l

    def _rgb_at(self, scale: int) -> bool:
        """Whether `scale` codes RGB pixels (two units): scale 0, and
        every scale of the RGB baselines."""
        return scale == 0 or self.cfg.rgb_bicubic_baseline

    def _uniform_unit(self) -> Tuple[int, int]:
        """(channels, L) of unit 0: the coarsest bottleneck, or the
        baselines' coarsest downsampled image."""
        if self.cfg.rgb_bicubic_baseline:
            return 3, self._rgb.L
        return self.cfg.q.C, self._bn.L

    @staticmethod
    def _rgb_bn(pixels: torch.Tensor) -> torch.Tensor:
        """A decoded baseline scale as the next decoder reads it: its
        pixels minus the RGB mean, in float32, the bits of the encoder's
        BicubicDownsamplingEnc.bn_q."""
        return layers.sub_rgb_mean(pixels.to(torch.float32)).contiguous()

    # ------------------------------------------------------------ encode

    def encode(self, img: np.ndarray, pout: str) -> float:
        """Encode one (1,H,W,3) uint8 image; big ones are auto-cropped into
        .partN files."""
        if img.ndim == 3:
            img = img[None]
        if img.ndim != 4 or img.shape[0] != 1 or img.shape[3] != 3:
            raise ValueError(f"expected one (1,H,W,3) image, got {img.shape}")
        if auto_crop.needs_crop(img):
            comb = auto_crop.CropLossCombinator()
            unit_sums: List[int] = []
            for i, crop in enumerate(auto_crop.iter_crops(img)):
                bpsp = self.encode(crop,
                                   pout + part_suffix.make_part_suffix(i))
                comb.add(bpsp, int(np.prod(crop.shape[1:3])))
                part_units = self.last_unit_bytes[0]
                unit_sums = [a + b for a, b in zip(
                    unit_sums or [0] * len(part_units), part_units)]
            # the whole image's per-unit bytes: the sum over its part files
            self.last_unit_bytes = [unit_sums]
            return comb.get_bpsp()
        return self.encode_batch([img], [pout])[0]

    def stage_batch(self, imgs: Sequence[np.ndarray]) -> dict:
        """Pad and upload a batch of same-shape uint8 images ONCE. The
        returned handle feeds encode_batch(staged=...) and verify_batch:
        for serving pipelines whose pixels stay on the device, they cross
        the host link once instead of once per use."""
        B = len(imgs)
        F = fbatch_for(B)
        padded, pad_tuples = [], []
        for im in imgs:
            im = im if im.ndim == 4 else im[None]
            pd, tup = pad_mod.pad(np.asarray(im), self.cfg.padding_fac,
                                  "constant")
            padded.append(pd[0])
            pad_tuples.append(tup)
        # pad the batch to the physical fbatch by repeating image 0; the
        # dummy slots are coded too (their streams are never written)
        x = _upload(np.stack(padded + [padded[0]] * (F - B)), self.device)
        return dict(x=x, pad_tuples=pad_tuples, B=B, F=F)

    def encode_batch(self, imgs: Optional[Sequence[np.ndarray]],
                     pouts: Sequence[str], staged: Optional[dict] = None
                     ) -> List[float]:
        """Encode B same-shape uint8 images together; writes one v8 file
        each and returns their bpsp (over the pre-pad subpixels). With
        staged=stage_batch(...) (imgs None) the device-resident pixels are
        coded without another upload. (encode_batch_async +
        encode_batch_finish.)"""
        return self.encode_batch_finish(
            self.encode_batch_async(imgs, pouts, staged))

    def encode_batch_async(self, imgs: Optional[Sequence[np.ndarray]],
                           pouts: Sequence[str],
                           staged: Optional[dict] = None) -> dict:
        """Dispatch a batch's encode without waiting for the card: the
        forward, the get_Ps, the packs and the rANS encodes launch on the
        current stream, then one non_blocking copy of every unit's lengths
        and words (the full (streams, T + 2) matrices: what each stream
        uses is known only from its length) to pinned memory. Returns the
        handle for encode_batch_finish, which writes the files."""
        if staged is None:
            if imgs is None:
                raise ValueError("encode_batch needs imgs or staged")
            staged = self.stage_batch(imgs)
        x, pad_tuples = staged["x"], staged["pad_tuples"]
        B, F = staged["B"], staged["F"]
        if B != len(pouts):
            raise ValueError(f"{B} images but {len(pouts)} output paths")
        for p in pouts:
            if os.path.isfile(p):
                raise FileExistsError(p)
        _, H, W, _ = x.shape
        S, C_bn, topk = self.cfg.num_scales, self.cfg.q.C, self.coder_topk
        times = self.times
        with torch.inference_mode():
            with times.run("[-] forward+uniform"):
                per_scale = self.net.enc_forward(
                    layers.sub_rgb_mean(x.to(torch.float32)))
                syms_c = per_scale[-1].syms
                n_u = syms_c.shape[1] * syms_c.shape[2]
                T_u = gc.t_policy(n_u, self.coder_profile)
                C_u, L_u = self._uniform_unit()
                units = [gc.encode_uniform(
                    _group_syms(syms_c), L_u,
                    gc.layout_for(n_u, C_u * F, T_u))]
            units_C, units_T = [C_u], [T_u]
            dec_F, bn_prev = None, per_scale[S - 1].bn_q
            for scale in reversed(range(S)):
                with times.prefix_scope(f"[{scale}]"):
                    with times.run("get_P"):
                        ip, dec_F, _ = self._get_P_int(scale, topk, bn_prev,
                                                       dec_F)
                    target = x if scale == 0 else per_scale[scale - 1].syms
                    if scale:
                        bn_prev = per_scale[scale - 1].bn_q
                    n = target.shape[1] * target.shape[2]
                    T_u = gc.t_policy(n, self.coder_profile)
                    with times.run("lookups+rans"):
                        if self._rgb_at(scale):
                            wc, lc, wf, lf = self._enc_rgb_units(ip, target,
                                                                 T_u)
                            units += [(wc, lc), (wf, lf)]
                            units_C += [3, 3]
                            units_T += [T_u, T_u]
                        else:
                            units.append(self._enc_bn_unit(ip, target, T_u))
                            units_C.append(C_bn)
                            units_T.append(T_u)
            fetch = _fetch_async([(ln, True) for _, ln in units]
                                 + [(w, False) for w, _ in units])
        return dict(fetch=fetch, units_C=units_C, units_T=units_T,
                    pouts=list(pouts), pad_tuples=pad_tuples, B=B, F=F,
                    H=H, W=W, topk=topk)

    def encode_batch_finish(self, handle: dict) -> List[float]:
        """Wait for an encode handle's one fetch, write its files; their
        bpsp."""
        pouts, pad_tuples = handle["pouts"], handle["pad_tuples"]
        F, H, W, topk = handle["F"], handle["H"], handle["W"], handle["topk"]
        units_C, units_T = handle["units_C"], handle["units_T"]
        S, times = self.cfg.num_scales, self.times
        with times.run("fetch"):
            arrs = _fetch_finish(handle["fetch"])
            n_u = len(units_C)
            host = [(w[:, :max(2, int(ln.max()))], ln.astype(np.int64))
                    for w, ln in zip(arrs[n_u:], arrs[:n_u])]
        canary = self.canary(topk)
        bpsps = []
        self.last_unit_bytes = []
        with times.run("write"):
            for b, pout in enumerate(pouts):
                unit_bytes = []
                with open(pout, "wb") as fout:
                    fout.write(MAGIC)
                    fout.write(struct.pack("<BBBB", self.VERSION, S, F,
                                           topk & 0xFF))
                    fout.write(struct.pack("<I", canary))
                    fout.write(struct.pack("<4H", *pad_tuples[b]))
                    fout.write(struct.pack("<HH", H, W))
                    for (words, lens), C, T in zip(host, units_C, units_T):
                        ns_c = words.shape[0] // (C * F)
                        w_b = words.reshape(C, F, ns_c, -1)[:, b]
                        l_b = lens.reshape(C, F, ns_c)[:, b]
                        at = fout.tell()
                        _write_unit(fout, w_b.reshape(-1, w_b.shape[-1]),
                                    l_b.reshape(-1), T)
                        unit_bytes.append(fout.tell() - at)
                        fout.write(struct.pack("<I", MAGIC_SEP))
                pl_, pr_, pt_, pb_ = pad_tuples[b]
                n_sp = (H - pt_ - pb_) * (W - pl_ - pr_) * 3
                bpsps.append(os.path.getsize(pout) * 8 / float(n_sp))
                self.last_unit_bytes.append(unit_bytes)
        return bpsps

    def unit_scale_map(self) -> List[str]:
        """The scale each file unit codes, aligned with last_unit_bytes:
        ['uniform', 'scale_{S-1}', ..., 'scale_0', 'scale_0'] (an RGB
        scale has two units, coarse and fine)."""
        return ["uniform"] + [f"scale_{s}" for s in
                              reversed(range(self.cfg.num_scales))
                              for _ in range(2 if self._rgb_at(s) else 1)]

    def _enc_rgb_units(self, ip, target, T):
        """Both scale-0 units (coarse + fine) in ONE rANS launch over the
        stacked 6*F channel streams; split back into the two units."""
        F, h, w, _ = target.shape
        lay6 = gc.layout_for(h * w, 6 * F, T)
        w6, l6 = gc.encode_rgb(ip, target.permute(3, 0, 1, 2).reshape(3, -1),
                               lay6)
        half = 3 * F * lay6.ns_c
        return w6[:half], l6[:half], w6[half:], l6[half:]

    def _enc_bn_unit(self, ip, syms_nhwc, T):
        F, h, w, C = syms_nhwc.shape
        syms_cm = syms_nhwc.permute(3, 0, 1, 2).reshape(C, -1)
        return gc.encode_bn(ip, syms_cm, self._bn.L,
                            gc.layout_for(h * w, C * F, T))

    # ------------------------------------------------------------ decode

    def decode(self, pin: str, _recurse_part: bool = True) -> np.ndarray:
        if _recurse_part and part_suffix.contains_part_suffix(pin):
            parts = [self.decode(p, _recurse_part=False)
                     for p in part_suffix.iter_part_paths(pin)]
            return auto_crop.stitch(parts)
        return self.decode_batch([pin])[0]

    def decode_batch(self, pins: Sequence[str], float_rows: bool = False
                     ) -> List[np.ndarray]:
        """Decode B same-shape v8 files together -> (1,H,W,3) uint8 each
        (decode_batch_async + decode_batch_finish)."""
        return self.decode_batch_finish(
            self.decode_batch_async(pins, float_rows))

    def decode_batch_async(self, pins: Sequence[str],
                           float_rows: bool = False) -> dict:
        """Decode B same-shape v8 files together and LEAVE the decoded
        batch on the device: the host reads and parses the files, uploads
        every unit's words in one non_blocking copy from pinned memory,
        and dispatches the decode without waiting for the card. The
        handle holds `imgs`, (F,H,W,3) uint8 (padded, the dummy slots
        b >= B repeating file 0), for verify_batch_async or a consumer on
        the device; decode_batch_finish fetches the images.

        float_rows: also build the scale-0 v7 FLOAT CDF rows (coarse and
        fine, all three channels with the lambda chain on the decoded
        values, through ops/float_cdf's kernels) on the decoded scale's
        parameters, into `self.last_float_rows`. They do not take part in
        decoding."""
        B = len(pins)
        S = self.cfg.num_scales
        C_bn = self.cfg.q.C
        C_u, L_u = self._uniform_unit()
        unit_Cs = [C_u] + [C for s in reversed(range(S))
                           for C in ([3, 3] if self._rgb_at(s) else [C_bn])]
        headers, per_file_units = [], []
        for pin in pins:
            hdr, units = _read_file(pin, S, len(unit_Cs))
            headers.append(hdr)
            per_file_units.append(units)
        H, W, F = headers[0]["H"], headers[0]["W"], headers[0]["F"]
        for hdr in headers:
            if (hdr["H"], hdr["W"]) != (H, W):
                raise DecodeError("decode_batch needs same-shape files")
            if hdr["F"] != F:
                raise DecodeError(
                    "decode_batch needs files with the same fbatch "
                    f"(got {hdr['F']} and {F}); decode them separately")
        if B > F:
            raise DecodeError(f"decoding {B} files of fbatch {F} together "
                              f"would change float programs; decode in "
                              f"groups of <= {F}")
        topks = {hdr["topk"] for hdr in headers}
        if len(topks) != 1:
            raise DecodeError("decode_batch needs files with one coder "
                              f"topk (got {sorted(topks)})")
        topk = topks.pop()
        want = self.canary(topk)
        for pin, hdr in zip(pins, headers):
            if hdr["canary"] != want:
                raise DecodeError(
                    f"{pin}: coder-numerics canary mismatch (file "
                    f"{hdr['canary']:#010x}, this build {want:#010x}): the "
                    "file was written by a build whose float pack stage "
                    "rounds differently; it is NOT corrupt, but decoding "
                    "it here would corrupt pixels. Decode it with the "
                    "build that wrote it.")
        times = self.times
        with times.run("upload"):
            mats = [self._unit_words(per_file_units, ui, C, B, F)
                    for ui, C in enumerate(unit_Cs)]
            flat = _upload(np.concatenate([m.reshape(-1) for m, _ in mats]),
                           self.device)
            unit_words, off = [], 0
            for m, T_u in mats:
                unit_words.append((flat[off:off + m.size].view(m.shape), T_u))
                off += m.size
        with torch.inference_mode():
            h, w = H >> S, W >> S
            with times.run("uniform decode"):
                words, T0 = unit_words[0]
                syms = _ungroup_syms(gc.decode_uniform(
                    words, L_u, gc.layout_for(h * w, C_u * F, T0)).long(),
                    F, h, w)
                bn_prev = (self._rgb_bn(syms) if self.cfg.rgb_bicubic_baseline
                           else levels_select(self._bn_levels, syms))
            dec_F, ui = None, 1
            for scale in reversed(range(S)):
                with times.prefix_scope(f"[{scale}]"):
                    with times.run("get_P"):
                        ip, dec_F, l = self._get_P_int(scale, topk, bn_prev,
                                                       dec_F)
                    hs, ws = H >> scale, W >> scale
                    with times.run("rows+rans"):
                        if self._rgb_at(scale):
                            (w_c, T_c), (w_f, T_f) = unit_words[ui:ui + 2]
                            ui += 2
                            decoded = self._decode_rgb(ip, w_c, w_f, F, hs,
                                                       ws, T_c, T_f)
                            if scale:
                                bn_prev = self._rgb_bn(decoded)
                        else:
                            words, T_u = unit_words[ui]
                            ui += 1
                            syms = gc.decode_bn(
                                ip, words, self._bn.L,
                                gc.layout_for(hs * ws, C_bn * F, T_u))
                            bn_prev = levels_select(
                                self._bn_levels,
                                _ungroup_syms(syms.long(), F, hs, ws))
            if float_rows:
                self.last_float_rows = self._float_rows(l, decoded)
            imgs = decoded.contiguous()
        return dict(imgs=imgs, headers=headers, B=B)

    def decode_batch_finish(self, handle: dict) -> List[np.ndarray]:
        """Fetch a decode handle's images (the one fetch, which waits for
        the card) -> (1,H,W,3) uint8 each, the padding undone."""
        B = handle["B"]
        with self.times.run("fetch images"):
            imgs = handle["imgs"][:B].cpu().numpy()
        out = []
        for b in range(B):
            im = imgs[b:b + 1]
            tup = handle["headers"][b]["pad"]
            if any(tup):
                im = pad_mod.undo_pad(im, *tup)
            out.append(im)
        return out

    def verify_batch(self, dec_handle: dict, staged: dict
                     ) -> Tuple[bool, int]:
        """Round-trip verification on the device: the decoded batch of
        decode_batch_async against the staged originals, without fetching
        pixels. Returns (all equal, u32 content hash of the decoded
        buffer): hash = sum_i px_i * ((i * 2654435761 mod 2^32) | 1) mod
        2^32 over the flattened (F,H,W,3) buffer, the JAX package's
        verify_batch_finish value for the same pixels.
        (verify_batch_async + verify_batch_finish.)"""
        return self.verify_batch_finish(
            self.verify_batch_async(dec_handle, staged))

    @staticmethod
    def verify_batch_async(dec_handle: dict, staged: dict) -> dict:
        """Dispatch verify_batch's flag and hash on the device and start
        their non_blocking copy (8 bytes' worth) to pinned memory; no
        pixel leaves the card. The handle is verify_batch_finish's."""
        return _fetch_async([(verify_pixels(dec_handle["imgs"],
                                            staged["x"]), True)])

    @staticmethod
    def verify_batch_finish(handle: dict) -> Tuple[bool, int]:
        """(all equal, u32 content hash) of a verify handle, once its copy
        has run."""
        flag, h = _fetch_finish(handle)[0]
        return bool(flag), int(h) & 0xFFFFFFFF

    def _unit_words(self, per_file_units, ui: int, C: int, B: int, F: int
                    ) -> Tuple[np.ndarray, int]:
        """One unit's (rows, cols) int32 word matrix on the host, rows
        channel-major / batch-minor with the dummy slots b >= B repeating
        file 0, zero past each row's length."""
        Ts = {per_file_units[b][ui][0] for b in range(B)}
        if len(Ts) != 1:
            raise DecodeError(f"unit {ui}: files use different stream "
                              f"lengths {sorted(Ts)}; decode separately")
        T_u = Ts.pop()
        lens = [per_file_units[b][ui][2] for b in range(B)]
        ns = lens[0].shape[0]
        if any(ln.shape[0] != ns for ln in lens):
            raise DecodeError("stream-count mismatch in batch")
        if ns % C:
            raise DecodeError(f"unit {ui}: {ns} streams not divisible by "
                              f"{C} channels")
        ns_c = ns // C
        cums = [np.concatenate([[0], np.cumsum(ln)]) for ln in lens]
        dense, lens_rows = [], []
        for c in range(C):
            for bp in range(F):
                b = bp if bp < B else 0
                lo = int(cums[b][c * ns_c])
                hi = int(cums[b][(c + 1) * ns_c])
                dense.append(per_file_units[b][ui][1][lo:hi])
                lens_rows.append(lens[b][c * ns_c:(c + 1) * ns_c])
        dense_np = np.concatenate(dense).astype(np.int32)
        lens_all = np.concatenate(lens_rows)
        cols = max(2, int(lens_all.max()))
        offs = np.concatenate([[0], np.cumsum(lens_all)])[:-1]
        col = np.arange(cols)
        valid = col[None, :] < lens_all[:, None]
        padded = np.zeros((lens_all.shape[0], cols), np.int32)
        padded[valid] = dense_np[(offs[:, None] + col[None, :])[valid]]
        return padded, T_u

    def _decode_rgb(self, ip, w_coarse, w_fine, F, hs, ws, T_c, T_f):
        """Channel-sequential two-level RGB decode with the lambda chain on
        decoded symbols: per channel, coarse symbols a, then fine symbols b
        conditional on a, s = 16a + b. Returns (F,hs,ws,3) uint8."""
        n = hs * ws
        dec = torch.zeros((3, F * n), dtype=torch.uint8, device=self.device)
        lay_c, lay_f = gc.layout_for(n, F, T_c), gc.layout_for(n, F, T_f)
        nsc, nsf = F * lay_c.ns_c, F * lay_f.ns_c
        for c in range(3):
            a = gc.decode_rgb_coarse(ip, c, dec,
                                     w_coarse[c * nsc:(c + 1) * nsc], lay_c)
            b = gc.decode_rgb_fine(ip, c, dec, a,
                                   w_fine[c * nsf:(c + 1) * nsf], lay_f)
            dec[c] = (a << FINE_BITS) | b
        return dec.reshape(3, F, hs, ws).permute(1, 2, 3, 0)

    def _float_rows(self, l0: torch.Tensor, decoded: torch.Tensor) -> dict:
        """Scale-0 v7 float rows (ops/float_cdf) of every channel on the
        decoded scale's params (l0 NCHW, read through an NHWC view), lambda
        chain on the decoded values, fine rows on the true coarse symbols."""
        packed = dmll_mod.pack_coder_params(self._rgb,
                                            l0.permute(0, 2, 3, 1), 3)
        dec_f = decoded.to(torch.float32)
        rows = []
        for c in range(3):
            a_c = decoded[..., c].reshape(-1) >> FINE_BITS
            rows.append((
                float_cdf.rgb_coarse_tables_packed(self._rgb, packed, c,
                                                   dec_f),
                float_cdf.rgb_fine_tables_packed(self._rgb, packed, c,
                                                 dec_f, a_c)))
        return dict(packed=packed, decoded=dec_f, rows=rows)


def content_hash(flat: torch.Tensor) -> torch.Tensor:
    """0-dim int64 u32 content hash of a flat integer tensor (see
    TorchBitcoding.verify_batch). int64 sums wrap mod 2^64, of which 2^32
    is a divisor, so the low 32 bits are exact at any size."""
    i = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    w = ((i * 2654435761) & 0xFFFFFFFF) | 1
    return torch.sum(flat.to(torch.int64) * w) & 0xFFFFFFFF


def verify_pixels(dec: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(dec == ref everywhere, content_hash(dec)) as an int32 pair on
    dec's device (the hash's u32 bits)."""
    if dec.shape != ref.shape:
        raise ValueError(f"decoded batch {tuple(dec.shape)} vs staged "
                         f"{tuple(ref.shape)}")
    with torch.inference_mode():
        h = content_hash(dec.reshape(-1))
        return torch.stack([torch.all(dec == ref).to(torch.int64),
                            h - ((h >> 31) << 32)]).to(torch.int32)


# ------------------------------------------------------------------ io


def _write_unit(fout, words: np.ndarray, lengths: np.ndarray, T: int):
    """words (NS, >=max(len)) u16-valued; lengths (NS,) words used.
    Unit header: T u16 | n_streams u32 | length block | payload."""
    ns, cols = words.shape
    fout.write(struct.pack("<HI", T, ns))
    lengths = lengths.astype(np.int64)
    base = int(lengths.min()) if ns else 0
    spread = int(lengths.max() - base) if ns else 0
    if spread <= 255:
        fout.write(struct.pack("<BH", 0, base))
        fout.write((lengths - base).astype(np.uint8).tobytes())
    else:
        fout.write(struct.pack("<B", 1))
        fout.write(lengths.astype("<u2").tobytes())
    mask = np.arange(cols)[None, :] < lengths[:, None]
    fout.write(words[mask].astype("<u2").tobytes())  # stream-major


def _read_unit(fin):
    """-> (T, dense stream-major payload u16, lengths int64 per stream)."""
    head = fin.read(6)
    if len(head) != 6:
        raise DecodeError("truncated unit header")
    T, ns = struct.unpack("<HI", head)
    if ns == 0 or ns > 1 << 24:
        raise DecodeError(f"bad stream count {ns}")
    if T < 8 or T % 8:
        raise DecodeError(f"bad stream length {T}")
    mode, = struct.unpack("<B", fin.read(1))
    if mode == 0:
        base, = struct.unpack("<H", fin.read(2))
        deltas = np.frombuffer(fin.read(ns), np.uint8)
        if deltas.size != ns:
            raise DecodeError("truncated length block")
        lengths = base + deltas.astype(np.int64)
    elif mode == 1:
        lengths = np.frombuffer(fin.read(2 * ns), "<u2").astype(np.int64)
        if lengths.size != ns:
            raise DecodeError("truncated length block")
    else:
        raise DecodeError(f"bad length-block mode {mode}")
    total = int(lengths.sum())
    payload = np.frombuffer(fin.read(2 * total), "<u2")
    if payload.size != total:
        raise DecodeError("truncated stream payload")
    if (lengths < 2).any():
        raise DecodeError("stream shorter than its rANS state")
    if (lengths > T + 2).any():
        raise DecodeError("stream longer than its symbols allow")
    return T, payload, lengths


def _read_file(pin: str, expect_scales: int, n_units: int):
    with open(pin, "rb") as fin:
        if fin.read(4) != MAGIC:
            raise DecodeError("bad magic")
        version, S, F, topk = struct.unpack("<BBBB", fin.read(4))
        if version != TorchBitcoding.VERSION:
            raise DecodeError(f"file is format v{version}; this is the "
                              f"v{TorchBitcoding.VERSION} decoder")
        if S != expect_scales:
            raise DecodeError("scale count mismatch")
        if F not in FBATCHES:
            raise DecodeError(f"bad fbatch {F}")
        canary, = struct.unpack("<I", fin.read(4))
        pad_tuple = struct.unpack("<4H", fin.read(8))
        H, W = struct.unpack("<HH", fin.read(4))
        units = []
        for _ in range(n_units):
            units.append(_read_unit(fin))
            sep = fin.read(4)
            if len(sep) != 4 or struct.unpack("<I", sep)[0] != MAGIC_SEP:
                raise DecodeError("magic separator mismatch — corrupt stream")
    return {"S": S, "H": H, "W": W, "F": F, "pad": pad_tuple,
            "canary": canary, "topk": topk}, units
