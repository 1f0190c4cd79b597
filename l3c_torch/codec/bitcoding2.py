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

Scale coding structure (per image, one file "unit" each):
  unit 0:            coarsest bottleneck, uniform prior, all channels
  per scale coarse->fine:
    bn scales:       ONE unit, all q.C channels, 2-edge lookups on encode,
                     full rows on decode
    RGB scale 0:     TWO units (two-level coding): 16-ary coarse symbols,
                     then 16-ary fine symbols conditional on the coarse bin;
                     decode runs channel by channel through the lambda chain

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
from ..models import dmll as dmll_mod
from ..models import grids, layers
from ..models.network import MultiscaleNetwork
from ..models.quantizer import levels_select
from ..ops import float_cdf
from ..ops import gpu_coder as gc
from ..ops import int_coder as ic
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


def contract_canary(rgb_spec, bn_spec, C_bn: int, K: int, topk: int,
                    device: torch.device) -> int:
    """u32 attestation that THIS process produces the coder numerics the
    encoder's did: the v8 chain (pack_int_params, the one float stage,
    then decode rows and encode 2-edge lookups, bn and two-level RGB) on
    fixed synthetic network outputs, CRC32'd. The inputs, the chain and the
    byte layout are the JAX package's, so the canaries agree exactly when
    both packages' float pack rounds the same way."""
    l_rgb, l_bn, t_rgb, t_bn = canary_inputs(bn_spec, C_bn, K)

    def dev(a):
        return torch.from_numpy(a).to(device)

    with torch.inference_mode():
        leaves = canary_leaves(
            ic.pack_int_params(rgb_spec, dev(l_rgb), 3, topk),
            ic.pack_int_params(bn_spec, dev(l_bn), C_bn, topk),
            dev(t_rgb), dev(t_bn), bn_spec.L)
    blob = b"".join(x.cpu().numpy().astype(dt).tobytes() for x, dt in leaves)
    return zlib.crc32(blob) & 0xFFFFFFFF


class TorchBitcoding:
    """Encode/decode images with the on-device coder (format v8)."""

    VERSION = 8

    def __init__(self, cfg: MsConfig, net: MultiscaleNetwork,
                 device: DeviceLike = None,
                 coder_profile: Optional[str] = None,
                 coder_topk: Optional[int] = None):
        """net: a MultiscaleNetwork with its weights loaded; it is moved to
        `device` (CUDA unless the caller passes "cpu").
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
        """get_P + pack_int_params: the codec's only float stage, shared by
        encode and decode. Returns (IntParams, decoder feature, l)."""
        l, F = self.net.get_P(scale, bn, dec_F)
        spec, C = (self._rgb, 3) if scale == 0 else (self._bn, self.cfg.q.C)
        return ic.pack_int_params(spec, l, C, topk), F, l

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
            for i, crop in enumerate(auto_crop.iter_crops(img)):
                bpsp = self.encode(crop,
                                   pout + part_suffix.make_part_suffix(i))
                comb.add(bpsp, int(np.prod(crop.shape[1:3])))
            return comb.get_bpsp()
        return self.encode_batch([img], [pout])[0]

    def encode_batch(self, imgs: Sequence[np.ndarray],
                     pouts: Sequence[str]) -> List[float]:
        """Encode B same-shape uint8 images together; writes one v8 file
        each and returns their bpsp (over the pre-pad subpixels)."""
        B = len(imgs)
        if B != len(pouts):
            raise ValueError(f"{B} images but {len(pouts)} output paths")
        for p in pouts:
            if os.path.isfile(p):
                raise FileExistsError(p)
        F = fbatch_for(B)
        padded, pad_tuples = [], []
        for im in imgs:
            im = im if im.ndim == 4 else im[None]
            pd, tup = pad_mod.pad(np.asarray(im), self.cfg.padding_fac,
                                  "constant")
            padded.append(pd[0])
            pad_tuples.append(tup)
        # pad the batch to the physical fbatch by repeating image 0
        x = torch.from_numpy(np.stack(padded + [padded[0]] * (F - B))
                             ).to(self.device)
        _, H, W, _ = x.shape
        S, C_bn, topk = self.cfg.num_scales, self.cfg.q.C, self.coder_topk
        with torch.inference_mode():
            per_scale = self.net.enc_forward(
                layers.sub_rgb_mean(x.to(torch.float32)))
            syms_c = per_scale[-1].syms
            n_u = syms_c.shape[1] * syms_c.shape[2]
            T_u = gc.t_policy(n_u, self.coder_profile)
            units = [gc.encode_uniform(_group_syms(syms_c), self.cfg.q.L,
                                       gc.layout_for(n_u, C_bn * F, T_u))]
            units_C, units_T = [C_bn], [T_u]
            dec_F, bn_prev = None, per_scale[S - 1].bn_q
            for scale in reversed(range(S)):
                ip, dec_F, _ = self._get_P_int(scale, topk, bn_prev, dec_F)
                target = x if scale == 0 else per_scale[scale - 1].syms
                n = target.shape[1] * target.shape[2]
                T_u = gc.t_policy(n, self.coder_profile)
                if scale == 0:
                    wc, lc, wf, lf = self._enc_rgb_units(ip, target, T_u)
                    units += [(wc, lc), (wf, lf)]
                    units_C += [3, 3]
                    units_T += [T_u, T_u]
                else:
                    bn_prev = per_scale[scale - 1].bn_q
                    units.append(self._enc_bn_unit(ip, target, T_u))
                    units_C.append(C_bn)
                    units_T.append(T_u)
            host = []
            for words, lens in units:
                lens_np = lens.cpu().numpy().astype(np.int64)
                need = max(2, int(lens_np.max()))
                host.append((words[:, :need].cpu().numpy(), lens_np))
        canary = self.canary(topk)
        bpsps = []
        for b, pout in enumerate(pouts):
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
                    _write_unit(fout, w_b.reshape(-1, w_b.shape[-1]),
                                l_b.reshape(-1), T)
                    fout.write(struct.pack("<I", MAGIC_SEP))
            pl_, pr_, pt_, pb_ = pad_tuples[b]
            n_sp = (H - pt_ - pb_) * (W - pl_ - pr_) * 3
            bpsps.append(os.path.getsize(pout) * 8 / float(n_sp))
        return bpsps

    def rgb_lookups(self, ip: ic.IntParams, target: torch.Tensor):
        """Scale-0 2-edge lookups: (start, freq) of all coarse units then all
        fine units, each (3*F*h*w,) channel-major, with the lambda chain on
        the true channel symbols."""
        t_i = target.to(torch.int64)
        a = t_i >> FINE_BITS
        bsym = t_i & ((1 << FINE_BITS) - 1)
        sc_, fc_, sf_, ff_ = [], [], [], []
        for c in range(3):
            dec = tuple(t_i[..., j].reshape(-1) for j in range(c))
            a_c, b_c = a[..., c].reshape(-1), bsym[..., c].reshape(-1)
            s1, f1 = ic.rgb_coarse_lookup(ip, c, dec, a_c)
            s2, f2 = ic.rgb_fine_lookup(ip, c, dec, a_c, b_c)
            sc_.append(s1), fc_.append(f1), sf_.append(s2), ff_.append(f2)
        return torch.cat(sc_ + sf_), torch.cat(fc_ + ff_)

    def _enc_rgb_units(self, ip, target, T):
        """Both scale-0 units (coarse + fine) in ONE rANS launch over the
        stacked 6*F channel streams (the streams are independent, so
        stacking only widens the launch); split back into the two units."""
        F, h, w, _ = target.shape
        start, freq = self.rgb_lookups(ip, target)
        lay6 = gc.layout_for(h * w, 6 * F, T)
        w6, l6 = gc.encode_sf(start, freq, lay6)
        half = 3 * F * lay6.ns_c
        return w6[:half], l6[:half], w6[half:], l6[half:]

    def _enc_bn_unit(self, ip, syms_nhwc, T):
        F, h, w, C = syms_nhwc.shape
        syms_cm = syms_nhwc.permute(3, 0, 1, 2).reshape(C, -1)
        start, freq = ic.bn_lookup(ip, syms_cm, C, self._bn.L)
        return gc.encode_sf(start, freq, gc.layout_for(h * w, C * F, T))

    # ------------------------------------------------------------ decode

    def decode(self, pin: str, _recurse_part: bool = True) -> np.ndarray:
        if _recurse_part and part_suffix.contains_part_suffix(pin):
            parts = [self.decode(p, _recurse_part=False)
                     for p in part_suffix.iter_part_paths(pin)]
            return auto_crop.stitch(parts)
        return self.decode_batch([pin])[0]

    def decode_batch(self, pins: Sequence[str], float_rows: bool = False
                     ) -> List[np.ndarray]:
        """Decode B same-shape v8 files together -> (1,H,W,3) uint8 each.

        float_rows: also build the scale-0 v7 FLOAT CDF rows (coarse and
        fine, all three channels with the lambda chain on the decoded
        values, through ops/float_cdf's kernels) on the decoded scale's
        parameters, into `self.last_float_rows`. They do not take part in
        decoding."""
        B = len(pins)
        S = self.cfg.num_scales
        C_bn = self.cfg.q.C
        unit_Cs = [C_bn] + [C_bn] * (S - 1) + [3, 3]
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
        unit_words = [self._unit_words(per_file_units, ui, C, B, F)
                      for ui, C in enumerate(unit_Cs)]
        with torch.inference_mode():
            h, w = H >> S, W >> S
            words, T0 = unit_words[0]
            syms = gc.decode_uniform(words, self._bn.L,
                                     gc.layout_for(h * w, C_bn * F, T0))
            bn_prev = levels_select(self._bn_levels,
                                    _ungroup_syms(syms, F, h, w))
            dec_F = None
            for scale in reversed(range(S)):
                ip, dec_F, l = self._get_P_int(scale, topk, bn_prev, dec_F)
                hs, ws = H >> scale, W >> scale
                if scale == 0:
                    (w_c, T_c), (w_f, T_f) = unit_words[-2:]
                    decoded = self._decode_rgb(ip, w_c, w_f, F, hs, ws,
                                               T_c, T_f)
                else:
                    words, T_u = unit_words[S - scale]
                    tables = ic.bn_rows(ip, C_bn, self._bn.L)
                    syms = gc.decode_channels(
                        tables, words, self._bn.L,
                        gc.layout_for(hs * ws, C_bn * F, T_u))
                    bn_prev = levels_select(self._bn_levels,
                                            _ungroup_syms(syms, F, hs, ws))
            if float_rows:
                self.last_float_rows = self._float_rows(l, decoded)
            imgs = decoded.to(torch.uint8).cpu().numpy()
        out = []
        for b in range(B):
            im = imgs[b:b + 1]
            tup = headers[b]["pad"]
            if any(tup):
                im = pad_mod.undo_pad(im, *tup)
            out.append(im)
        return out

    def _unit_words(self, per_file_units, ui: int, C: int, B: int, F: int
                    ) -> Tuple[torch.Tensor, int]:
        """One unit's (rows, cols) int32 word matrix on the device, rows
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
        return torch.from_numpy(padded).to(self.device), T_u

    def _decode_rgb(self, ip, w_coarse, w_fine, F, hs, ws, T_c, T_f):
        """Channel-sequential two-level RGB decode with the lambda chain on
        decoded symbols: per channel, coarse rows -> a, conditional fine
        rows from a -> b, s = 16a + b. Returns (F,hs,ws,3) int64."""
        n = hs * ws
        decoded = torch.zeros((F, hs, ws, 3), dtype=torch.int64,
                              device=self.device)
        nsc = gc.layout_for(n, 1, T_c).ns_c
        nsf = gc.layout_for(n, 1, T_f).ns_c
        for c in range(3):
            dec = tuple(decoded[..., j].reshape(-1) for j in range(c))
            ct = ic.rgb_coarse_rows(ip, c, dec)
            a_flat = gc.decode_channels(
                ct, w_coarse[c * F * nsc:(c + 1) * F * nsc],
                ic.N_COARSE, gc.layout_for(n, F, T_c)).reshape(-1)
            ft = ic.rgb_fine_rows(ip, c, dec, a_flat)
            b_flat = gc.decode_channels(
                ft, w_fine[c * F * nsf:(c + 1) * F * nsf],
                ic.FINE, gc.layout_for(n, F, T_f)).reshape(-1)
            decoded[..., c] = ((a_flat.to(torch.int64) << FINE_BITS)
                               | b_flat.to(torch.int64)).reshape(F, hs, ws)
        return decoded

    def _float_rows(self, l0: torch.Tensor, decoded: torch.Tensor) -> dict:
        """Scale-0 v7 float rows (ops/float_cdf) of every channel on the
        decoded scale's params, lambda chain on the decoded values, fine
        rows on the true coarse symbols."""
        packed = dmll_mod.pack_coder_params(self._rgb, l0, 3)
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
