"""DDS files as the JAX package's loader reads them: Pillow's
DdsImagePlugin and its BcnDecode.c, then convert("RGB").

Read here, as Pillow 12.1 reads them:
  - uncompressed RGB / RGBA by bit masks (each channel scaled by
    int(v / max * 255)), luminance (L, LA), 8-bit palettes (a 256-entry
    RGBA table after the header) and DX10 R8G8B8A8;
  - BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 (ATI1 / BC4U), BC5 (ATI2 /
    BC5U, and BC5S, whose blue Pillow sets to 128), by FourCC or DX10
    format, with BcnDecode.c's integer
    interpolation (thirds and halves of the 5:6:5 endpoints expanded by
    bit replication; the 8- and 6-step alpha ramps);
  - BC7: its eight modes, partitions, anchors, p-bits, rotations and
    index selection, the reserved mode giving zeros;
  - BC6H, unsigned and signed: its fourteen modes' bit layouts, the
    delta endpoints (BcnDecode.c's: a delta's sum with the base endpoint
    kept to the endpoint's bits and, in the signed format, read as a
    16-bit signed value without a second sign extension), unquantization,
    the interpolation without a rounding term, the 31/64 (31/32) scale to
    half floats, which Pillow clamps to [0, 1] and truncates after * 255.
Alpha is dropped by convert("RGB").
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_DDPF_ALPHA, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000

_FOURCC = {b"DXT1": ("RGBA", 1), b"DXT3": ("RGBA", 2), b"DXT5": ("RGBA", 3),
           b"BC4U": ("L", 4), b"ATI1": ("L", 4), b"BC5S": ("RGB", -5),
           b"BC5U": ("RGB", 5), b"ATI2": ("RGB", 5)}
_DXGI = {70: ("RGBA", 1), 71: ("RGBA", 1), 73: ("RGBA", 2), 74: ("RGBA", 2),
         76: ("RGBA", 3), 77: ("RGBA", 3), 79: ("L", 4), 80: ("L", 4),
         82: ("RGB", 5), 83: ("RGB", 5), 84: ("RGB", -5), 95: ("RGB", 6),
         96: ("RGB", -6), 97: ("RGBA", 7), 98: ("RGBA", 7), 99: ("RGBA", 7),
         27: ("RGBA", 0), 28: ("RGBA", 0), 29: ("RGBA", 0)}


def _parse(blob: bytes, path: str):
    """DdsImageFile._open -> (mode, w, h, kind, detail, data offset)."""
    if blob[:4] != b"DDS ":
        raise ValueError(f"{path}: not a DDS file")
    if len(blob) < 8 or struct.unpack("<I", blob[4:8])[0] != 124:
        raise ValueError(f"{path}: DDS header size is not 124 (Pillow "
                         "refuses it)")
    hd = blob[8:128]
    if len(hd) != 120:
        raise ValueError(f"{path}: incomplete DDS header")
    _, h, w = struct.unpack("<3I", hd[:12])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", hd[72:84])
    if pfflags & _DDPF_RGB:
        alpha = pfflags & _DDPF_ALPHA
        masks = struct.unpack(f"<{4 if alpha else 3}I", hd[84:100 if alpha
                                                        else 96])
        return ("RGBA" if alpha else "RGB"), w, h, "masks", (bitcount, masks
                                                              ), 128
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            return "L", w, h, "raw", 1, 128
        if bitcount == 16 and pfflags & _DDPF_ALPHA:
            return "LA", w, h, "raw", 2, 128
        raise ValueError(f"{path}: DDS luminance of {bitcount} bits (Pillow "
                         "refuses it)")
    if pfflags & _DDPF_PAL8:
        return "P", w, h, "palette", None, 128
    if pfflags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            fmt = struct.unpack("<I", blob[128:132])[0]
            if fmt not in _DXGI:
                raise ValueError(f"{path}: DXGI format {fmt} (Pillow: "
                                 "unimplemented)")
            mode, n = _DXGI[fmt]
            if n == 0:
                return mode, w, h, "raw", 4, 148
            return mode, w, h, "bcn", n, 148
        if fourcc not in _FOURCC:
            raise ValueError(f"{path}: DDS pixel format {fourcc!r} (Pillow: "
                             "unimplemented)")
        mode, n = _FOURCC[fourcc]
        return mode, w, h, "bcn", n, 128
    raise ValueError(f"{path}: unknown DDS pixel format flags {pfflags}")


def dds_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    mode, w, h, _, _, _ = _parse(blob, path)
    return mode, h, w


# ------------------------------------------------------------- BC1 - BC5

def _bc1_colours(blocks: np.ndarray, four: bool) -> np.ndarray:
    """(n, 8) BC1 colour blocks -> (n, 16, 4) RGBA; four=True always uses
    the four-colour ramp (BC2 and BC3)."""
    c = blocks[:, :4].copy().view("<u2").astype(np.int32)       # (n, 2)
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    e = np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)      # (n, 2, 3)
    e0, e1 = e[:, 0], e[:, 1]
    opaque = (c[:, 0] > c[:, 1]) | four
    p2 = np.where(opaque[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(opaque[:, None], (e0 + 2 * e1) // 3, 0)
    pal = np.stack([e0, e1, p2, p3], 1)                         # (n, 4, 3)
    alpha = np.full((len(c), 4), 255)
    alpha[:, 3] = np.where(opaque, 255, 0)
    pal = np.concatenate([pal, alpha[..., None]], -1)
    lut = blocks[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc3_alpha(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 8) BC3 / BC4 alpha blocks -> (n, 16) values (BC5S: signed
    endpoints plus 128)."""
    a = blocks[:, :2].astype(np.int32)
    if signed:
        a = blocks[:, :2].view(np.int8).astype(np.int32) + 128
    a0, a1 = a[:, 0:1], a[:, 1:2]
    k = np.arange(1, 7)
    eight = np.concatenate([a0, a1, ((7 - k) * a0 + k * a1)[:, :6] // 7], 1)
    k4 = np.arange(1, 5)
    six = np.concatenate([a0, a1, ((5 - k4) * a0 + k4 * a1) // 5,
                          np.zeros_like(a0), np.full_like(a0, 255)], 1)
    ramp = np.where(a0 > a1, eight, six) & 255
    bits = blocks[:, 2:8].astype(np.int64)
    lo = bits[:, 0] | bits[:, 1] << 8 | bits[:, 2] << 16
    hi = bits[:, 3] | bits[:, 4] << 8 | bits[:, 5] << 16
    idx = np.concatenate([(lo[:, None] >> (3 * np.arange(8))) & 7,
                          (hi[:, None] >> (3 * np.arange(8))) & 7], 1)
    return np.take_along_axis(ramp, idx, 1)


def _bcn(blocks: np.ndarray, n: int, path: str) -> np.ndarray:
    """(count, bytes) blocks -> (count, 16, 3) RGB of each 4 x 4 block."""
    if n == 1:
        return _bc1_colours(blocks, False)[..., :3]
    if n in (2, 3):
        return _bc1_colours(blocks[:, 8:], True)[..., :3]
    if n == 4:
        return np.repeat(_bc3_alpha(blocks)[..., None], 3, -1)
    if abs(n) == 5:
        r = _bc3_alpha(blocks[:, :8], n < 0)
        g = _bc3_alpha(blocks[:, 8:], n < 0)
        return np.stack([r, g, np.full_like(r, 128 if n < 0 else 0)], -1)
    if n == 7:
        return _bc7(blocks)[..., :3]
    return _bc6(blocks, n < 0)


# ------------------------------------------------------------------ BC7

# (subsets, partition bits, rotation bits, index selection bits, colour
# bits, alpha bits, endpoint p-bits, shared p-bits, index bits, index-2
# bits) of modes 0 to 7
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_BC7_SI2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
            0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
            0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
            0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
            0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
            0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
            0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
            0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_BC7_SI3 = (0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000,
            0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500,
            0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450,
            0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
            0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4,
            0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
            0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
            0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
            0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
            0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8,
            0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414,
            0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
            0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254)
_BC7_AI0 = bytes((15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                  15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15,
                  15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6,
                  8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15))
_BC7_AI1 = bytes((3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3,
                  8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5,
                  6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5,
                  8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3))
_BC7_AI2 = bytes((15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
                  15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
                  15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15,
                  3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8))
_BC7_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
                4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                    64)}


def _subset(mode: int, ns: int, part: int, i: int) -> int:
    if ns == 2:
        return (_BC7_SI2[part] >> i) & 1
    if ns == 3:
        return (_BC7_SI3[part] >> (2 * i)) & 3
    return 0


def _anchor(ns: int, part: int, s: int) -> int:
    if s == 0:
        return 0
    if ns == 2:
        return _BC7_AI0[part]
    return (_BC7_AI1 if s == 1 else _BC7_AI2)[part]


def _bc7_block(v: int) -> list:
    """One 128-bit BC7 block (little-endian int) -> 16 RGBA tuples."""
    pos = 0

    def take(n):
        nonlocal pos
        x = (v >> pos) & ((1 << n) - 1)
        pos += n
        return x

    mode = 0
    while mode < 8 and not take(1):
        mode += 1
    if mode == 8:
        return [(0, 0, 0, 0)] * 16
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    part = take(pb)
    rot = take(rb)
    sel = take(isb)
    ends = [[[0] * 4 for _ in range(2)] for _ in range(ns)]
    for c in range(3):
        for s in range(ns):
            for e in range(2):
                ends[s][e][c] = take(cb)
    for s in range(ns):
        for e in range(2):
            ends[s][e][3] = take(ab) if ab else 255
    cbits, abits = cb, ab
    if epb:
        for s in range(ns):
            for e in range(2):
                p = take(1)
                for c in range(4 if ab else 3):
                    ends[s][e][c] = ends[s][e][c] << 1 | p
        cbits, abits = cb + 1, (ab + 1 if ab else 0)
    elif spb:
        for s in range(ns):
            p = take(1)
            for e in range(2):
                for c in range(3):
                    ends[s][e][c] = ends[s][e][c] << 1 | p
        cbits = cb + 1

    def expand(x, n):
        x <<= 8 - n
        return x | x >> n

    for s in range(ns):
        for e in range(2):
            for c in range(3):
                ends[s][e][c] = expand(ends[s][e][c], cbits)
            if ab:
                ends[s][e][3] = expand(ends[s][e][3], abits)
    idx = []
    for i in range(16):
        s = _subset(mode, ns, part, i)
        n = ib - (i == _anchor(ns, part, s))
        idx.append(take(n))
    idx2 = []
    if ib2:
        for i in range(16):
            idx2.append(take(ib2 - (i == 0)))
    out = []
    for i in range(16):
        s = _subset(mode, ns, part, i)
        e0, e1 = ends[s]
        if ib2:
            ci, ai = (idx2[i], idx[i]) if sel else (idx[i], idx2[i])
            cw = _BC7_WEIGHTS[ib2 if sel else ib][ci]
            aw = _BC7_WEIGHTS[ib if sel else ib2][ai]
        else:
            cw = aw = _BC7_WEIGHTS[ib][idx[i]]
        px = [((64 - cw) * e0[c] + cw * e1[c] + 32) >> 6 for c in range(3)]
        px.append(((64 - aw) * e0[3] + aw * e1[3] + 32) >> 6)
        if rot:
            px[3], px[rot - 1] = px[rot - 1], px[3]
        out.append(tuple(px))
    return out


def _bc7(blocks: np.ndarray) -> np.ndarray:
    return np.array([_bc7_block(int.from_bytes(b.tobytes(), "little"))
                     for b in blocks], np.int64).reshape(len(blocks), 16, 4)


# ----------------------------------------------------------------- BC6H

def _f(name, hi, lo):
    """Bits lo..hi of a field, in the order the block stores them."""
    return [(name, b) for b in range(lo, hi + 1)]


def _r(name, hi, lo):
    """Bits hi..lo of a field stored most significant first."""
    return [(name, b) for b in range(hi, lo - 1, -1)]


_W, _X, _Y, _Z = "w", "x", "y", "z"
# each mode: (mode bits, regions, transformed, endpoint bits, delta bits
# (r, g, b), the header's fields after the mode bits in stored order)
_BC6_MODES = {
    0b00: (2, True, 10, (5, 5, 5), (
        _f("gy", 4, 4) + _f("by", 4, 4) + _f("bz", 4, 4) + _f("rw", 9, 0)
        + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 4, 0) + _f("gz", 4, 4)
        + _f("gy", 3, 0) + _f("gx", 4, 0) + _f("bz", 0, 0) + _f("gz", 3, 0)
        + _f("bx", 4, 0) + _f("bz", 1, 1) + _f("by", 3, 0) + _f("ry", 4, 0)
        + _f("bz", 2, 2) + _f("rz", 4, 0) + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b01: (2, True, 7, (6, 6, 6), (
        _f("gy", 5, 5) + _f("gz", 4, 4) + _f("gz", 5, 5) + _f("rw", 6, 0)
        + _f("bz", 0, 0) + _f("bz", 1, 1) + _f("by", 4, 4) + _f("gw", 6, 0)
        + _f("by", 5, 5) + _f("bz", 2, 2) + _f("gy", 4, 4) + _f("bw", 6, 0)
        + _f("bz", 3, 3) + _f("bz", 5, 5) + _f("bz", 4, 4) + _f("rx", 5, 0)
        + _f("gy", 3, 0) + _f("gx", 5, 0) + _f("gz", 3, 0) + _f("bx", 5, 0)
        + _f("by", 3, 0) + _f("ry", 5, 0) + _f("rz", 5, 0) + _f("d", 4, 0))),
    0b00010: (2, True, 11, (5, 4, 4), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 4, 0)
        + _f("rw", 10, 10) + _f("gy", 3, 0) + _f("gx", 3, 0)
        + _f("gw", 10, 10) + _f("bz", 0, 0) + _f("gz", 3, 0) + _f("bx", 3, 0)
        + _f("bw", 10, 10) + _f("bz", 1, 1) + _f("by", 3, 0) + _f("ry", 4, 0)
        + _f("bz", 2, 2) + _f("rz", 4, 0) + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b00110: (2, True, 11, (4, 5, 4), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 3, 0)
        + _f("rw", 10, 10) + _f("gz", 4, 4) + _f("gy", 3, 0) + _f("gx", 4, 0)
        + _f("gw", 10, 10) + _f("gz", 3, 0) + _f("bx", 3, 0)
        + _f("bw", 10, 10) + _f("bz", 1, 1) + _f("by", 3, 0) + _f("ry", 3, 0)
        + _f("bz", 0, 0) + _f("bz", 2, 2) + _f("rz", 3, 0) + _f("gy", 4, 4)
        + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b01010: (2, True, 11, (4, 4, 5), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 3, 0)
        + _f("rw", 10, 10) + _f("by", 4, 4) + _f("gy", 3, 0) + _f("gx", 3, 0)
        + _f("gw", 10, 10) + _f("bz", 0, 0) + _f("gz", 3, 0) + _f("bx", 4, 0)
        + _f("bw", 10, 10) + _f("by", 3, 0) + _f("ry", 3, 0) + _f("bz", 1, 1)
        + _f("bz", 2, 2) + _f("rz", 3, 0) + _f("bz", 4, 4) + _f("bz", 3, 3)
        + _f("d", 4, 0))),
    0b01110: (2, True, 9, (5, 5, 5), (
        _f("rw", 8, 0) + _f("by", 4, 4) + _f("gw", 8, 0) + _f("gy", 4, 4)
        + _f("bw", 8, 0) + _f("bz", 4, 4) + _f("rx", 4, 0) + _f("gz", 4, 4)
        + _f("gy", 3, 0) + _f("gx", 4, 0) + _f("bz", 0, 0) + _f("gz", 3, 0)
        + _f("bx", 4, 0) + _f("bz", 1, 1) + _f("by", 3, 0) + _f("ry", 4, 0)
        + _f("bz", 2, 2) + _f("rz", 4, 0) + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b10010: (2, True, 8, (6, 5, 5), (
        _f("rw", 7, 0) + _f("gz", 4, 4) + _f("by", 4, 4) + _f("gw", 7, 0)
        + _f("bz", 2, 2) + _f("gy", 4, 4) + _f("bw", 7, 0) + _f("bz", 3, 3)
        + _f("bz", 4, 4) + _f("rx", 5, 0) + _f("gy", 3, 0) + _f("gx", 4, 0)
        + _f("bz", 0, 0) + _f("gz", 3, 0) + _f("bx", 4, 0) + _f("bz", 1, 1)
        + _f("by", 3, 0) + _f("ry", 5, 0) + _f("rz", 5, 0) + _f("d", 4, 0))),
    0b10110: (2, True, 8, (5, 6, 5), (
        _f("rw", 7, 0) + _f("bz", 0, 0) + _f("by", 4, 4) + _f("gw", 7, 0)
        + _f("gy", 5, 5) + _f("gy", 4, 4) + _f("bw", 7, 0) + _f("gz", 5, 5)
        + _f("bz", 4, 4) + _f("rx", 4, 0) + _f("gz", 4, 4) + _f("gy", 3, 0)
        + _f("gx", 5, 0) + _f("gz", 3, 0) + _f("bx", 4, 0) + _f("bz", 1, 1)
        + _f("by", 3, 0) + _f("ry", 4, 0) + _f("bz", 2, 2) + _f("rz", 4, 0)
        + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b11010: (2, True, 8, (5, 5, 6), (
        _f("rw", 7, 0) + _f("bz", 1, 1) + _f("by", 4, 4) + _f("gw", 7, 0)
        + _f("by", 5, 5) + _f("gy", 4, 4) + _f("bw", 7, 0) + _f("bz", 5, 5)
        + _f("bz", 4, 4) + _f("rx", 4, 0) + _f("gz", 4, 4) + _f("gy", 3, 0)
        + _f("gx", 4, 0) + _f("bz", 0, 0) + _f("gz", 3, 0) + _f("bx", 5, 0)
        + _f("by", 3, 0) + _f("ry", 4, 0) + _f("bz", 2, 2) + _f("rz", 4, 0)
        + _f("bz", 3, 3) + _f("d", 4, 0))),
    0b11110: (2, False, 6, (6, 6, 6), (
        _f("rw", 5, 0) + _f("gz", 4, 4) + _f("bz", 0, 0) + _f("bz", 1, 1)
        + _f("by", 4, 4) + _f("gw", 5, 0) + _f("gy", 5, 5) + _f("by", 5, 5)
        + _f("bz", 2, 2) + _f("gy", 4, 4) + _f("bw", 5, 0) + _f("gz", 5, 5)
        + _f("bz", 3, 3) + _f("bz", 5, 5) + _f("bz", 4, 4) + _f("rx", 5, 0)
        + _f("gy", 3, 0) + _f("gx", 5, 0) + _f("gz", 3, 0) + _f("bx", 5, 0)
        + _f("by", 3, 0) + _f("ry", 5, 0) + _f("rz", 5, 0) + _f("d", 4, 0))),
    0b00011: (1, False, 10, (10, 10, 10), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 9, 0)
        + _f("gx", 9, 0) + _f("bx", 9, 0))),
    0b00111: (1, True, 11, (9, 9, 9), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 8, 0)
        + _f("rw", 10, 10) + _f("gx", 8, 0) + _f("gw", 10, 10)
        + _f("bx", 8, 0) + _f("bw", 10, 10))),
    0b01011: (1, True, 12, (8, 8, 8), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 7, 0)
        + _r("rw", 11, 10) + _f("gx", 7, 0) + _r("gw", 11, 10)
        + _f("bx", 7, 0) + _r("bw", 11, 10))),
    0b01111: (1, True, 16, (4, 4, 4), (
        _f("rw", 9, 0) + _f("gw", 9, 0) + _f("bw", 9, 0) + _f("rx", 3, 0)
        + _r("rw", 15, 10) + _f("gx", 3, 0) + _r("gw", 15, 10)
        + _f("bx", 3, 0) + _r("bw", 15, 10))),
}


def _sext(v: int, bits: int) -> int:
    return v - (1 << bits) if v >> (bits - 1) & 1 else v


def _bc6_unquantize(v: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15:
            return v
        if v == 0:
            return 0
        if v == (1 << bits) - 1:
            return 0xFFFF
        return ((v << 16) + 0x8000) >> bits
    if bits >= 16:
        return v
    s, v = (1, -v) if v < 0 else (0, v)
    if v == 0:
        q = 0
    elif v >= (1 << (bits - 1)) - 1:
        q = 0x7FFF
    else:
        q = ((v << 15) + 0x4000) >> (bits - 1)
    return -q if s else q


def _bc6_block(v: int, signed: bool) -> list:
    """One 128-bit BC6H block -> 16 (r, g, b) half-float bit patterns."""
    mode = v & 3
    pos = 2
    if mode > 1:
        mode |= (v >> 2 & 7) << 2
        pos = 5
    if mode not in _BC6_MODES:
        return [(0, 0, 0)] * 16
    ns, transformed, wb, db, fields = _BC6_MODES[mode]
    vals = {}
    for name, bit in fields:
        vals[name] = vals.get(name, 0) | ((v >> pos) & 1) << bit
        pos += 1
    part = vals.get("d", 0)
    ends = [[vals.get(c + e, 0) for c in "rgb"] for e in "wxyz"[:2 * ns]]
    if signed:
        ends[0] = [_sext(x, wb) for x in ends[0]]
    if transformed or signed:
        for e in range(1, 2 * ns):
            ends[e] = [_sext(x, db[c]) for c, x in enumerate(ends[e])]
    if transformed:                 # the sum kept to wb bits, unsigned
        for e in range(1, 2 * ns):
            ends[e] = [(x + w) & ((1 << wb) - 1) for x, w in
                       zip(ends[e], ends[0])]
    if signed:                      # BcnDecode.c keeps endpoints in 16 bits
        ends = [[_sext(x & 0xFFFF, 16) for x in e] for e in ends]
    ends = [[_bc6_unquantize(x, wb, signed) for x in e] for e in ends]
    ib = 3 if ns == 2 else 4
    weights = _BC7_WEIGHTS[ib]
    pos = 82 if ns == 2 else 65
    out = []
    for i in range(16):
        s = (_BC7_SI2[part] >> i) & 1 if ns == 2 else 0
        anchor = i == 0 or ns == 2 and s == 1 and i == _BC7_AI0[part]
        n = ib - anchor
        idx = (v >> pos) & ((1 << n) - 1)
        pos += n
        e0, e1 = ends[2 * s], ends[2 * s + 1]
        px = []
        for c in range(3):
            x = (e0[c] * (64 - weights[idx]) + e1[c] * weights[idx]) >> 6
            if signed:
                x = -((-x * 31) >> 5) if x < 0 else (x * 31) >> 5
                x = 0x8000 | -x if x < 0 else x
            else:
                x = (x * 31) >> 6
            px.append(x)
        out.append(tuple(px))
    return out


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16) BC6H blocks -> (n, 16, 3) uint8 as Pillow gives them: the
    half floats clamped to [0, 1] and truncated after * 255.0f."""
    half = np.array([_bc6_block(int.from_bytes(b.tobytes(), "little"),
                                signed) for b in blocks], np.uint16)
    f = half.view(np.float16).astype(np.float32)
    return (np.clip(f, 0, 1) * np.float32(255)).astype(np.uint8)


# -------------------------------------------------------------- decoding

def decode_dds(blob: bytes, path: str = "<DDS bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a DDS file's main image, as Pillow's
    Image.open(...).convert("RGB") gives it."""
    mode, w, h, kind, detail, at = _parse(blob, path)
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    if kind == "bcn":
        size = 8 if detail in (1, 4) else 16
        bw, bh = -(-w // 4), -(-h // 4)
        data = blob[at:at + bw * bh * size]
        if len(data) < bw * bh * size:
            raise ValueError(f"{path}: truncated DDS data")
        px = _bcn(np.frombuffer(data, np.uint8).reshape(-1, size), detail,
                  path)
        px = px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
        return np.ascontiguousarray(px.reshape(4 * bh, 4 * bw, 3)[:h, :w]
                                    .astype(np.uint8))
    if kind == "masks":
        bitcount, masks = detail
        nb = bitcount // 8
        data = blob[at:at + nb * w * h]
        if nb < 1 or len(data) < nb * w * h:
            raise ValueError(f"{path}: truncated DDS data")
        v = np.frombuffer(data, np.uint8).reshape(-1, nb).astype(np.uint64)
        v = (v << (8 * np.arange(nb, dtype=np.uint64))).sum(1)
        chans = []
        for m in masks[:3]:
            if not m:
                chans.append(np.zeros(len(v), np.uint8))
                continue
            shift = (m & -m).bit_length() - 1
            total = m >> shift
            chans.append(((((v & np.uint64(m)) >> np.uint64(shift))
                           .astype(np.float64) / total) * 255).astype(
                np.uint8))
        return np.stack(chans, -1).reshape(h, w, 3)
    if kind == "palette":
        pal = np.frombuffer(blob[at:at + 1024], np.uint8)
        n = len(pal) // 4
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = pal[:4 * n].reshape(n, 4)[:, :3]
        data = blob[at + 1024:at + 1024 + w * h]
        if len(data) < w * h:
            raise ValueError(f"{path}: truncated DDS data")
        return lut[np.frombuffer(data, np.uint8).reshape(h, w)]
    data = blob[at:at + detail * w * h]
    if len(data) < detail * w * h:
        raise ValueError(f"{path}: truncated DDS data")
    px = np.frombuffer(data, np.uint8).reshape(h, w, detail)
    if detail <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
