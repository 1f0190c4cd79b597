"""Apple icon files (ICNS), read as Pillow's IcnsImagePlugin reads them.

The entries are walked as IcnsFile walks them (a later entry of the same
type replaces an earlier one); the size is `bestsize`, the largest
(width, height, scale) among the sizes whose entries are present; the
mode Pillow opens the file in is RGBA and its size best_size x scale.
The pixels come from that size's entries in IcnsFile.SIZES's order: a PNG
or JPEG 2000 payload (read_png_or_jpeg2000) wins; otherwise the 24-bit
RGB of it32 / ih32 / il32 / is32 (raw, or Apple's per-channel RLE of
read_32 / read_32t), whose mask (t8mk / h8mk / l8mk / s8mk) only has to
be long enough, since convert("RGB") drops it.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from . import jpeg2000

_PAYLOAD, _RLE, _RLE_T, _MASK = "payload", "rle", "rle_t", "mask"
# IcnsFile.SIZES: (width, height, scale) -> its entries, in reading order
SIZES = {
    (512, 512, 2): [(b"ic10", _PAYLOAD)],
    (512, 512, 1): [(b"ic09", _PAYLOAD)],
    (256, 256, 2): [(b"ic14", _PAYLOAD)],
    (256, 256, 1): [(b"ic08", _PAYLOAD)],
    (128, 128, 2): [(b"ic13", _PAYLOAD)],
    (128, 128, 1): [(b"ic07", _PAYLOAD), (b"it32", _RLE_T),
                    (b"t8mk", _MASK)],
    (64, 64, 1): [(b"icp6", _PAYLOAD)],
    (32, 32, 2): [(b"ic12", _PAYLOAD)],
    (48, 48, 1): [(b"ih32", _RLE), (b"h8mk", _MASK)],
    (32, 32, 1): [(b"icp5", _PAYLOAD), (b"il32", _RLE), (b"l8mk", _MASK)],
    (16, 16, 2): [(b"ic11", _PAYLOAD)],
    (16, 16, 1): [(b"icp4", _PAYLOAD), (b"is32", _RLE), (b"s8mk", _MASK)],
}


def _entries(blob: bytes, path: str) -> Dict[bytes, Tuple[int, int]]:
    """IcnsFile.__init__: type -> (offset of its data, its length)."""
    if len(blob) < 8 or blob[:4] != b"icns":
        raise ValueError(f"{path}: not an ICNS file")
    filesize, = struct.unpack(">I", blob[4:8])
    out, i = {}, 8
    while i < filesize:
        if i + 8 > len(blob):
            raise ValueError(f"{path}: ICNS cut short in its entries "
                             "(Pillow cannot identify it)")
        sig, size = struct.unpack(">4sI", blob[i:i + 8])
        if size <= 0:
            raise ValueError(f"{path}: ICNS: invalid block header")
        out[sig] = (i + 8, size - 8)
        i += size
    return out


def _sizes(entries) -> List[Tuple[int, int, int]]:
    return [s for s, fmts in SIZES.items()
            if any(code in entries for code, _ in fmts)]


def _best(blob: bytes, path: str):
    entries = _entries(blob, path)
    sizes = _sizes(entries)
    if not sizes:
        raise ValueError(f"{path}: ICNS: No 32bit icon resources found")
    return entries, sizes, max(sizes)


def icns_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """("RGBA", height, width): bestsize times its scale."""
    _, _, (w, h, scale) = _best(blob, path)
    return "RGBA", h * scale, w * scale


def _rle(blob: bytes, at: int, n: int, path: str) -> np.ndarray:
    """read_32's three channels of n samples each, read on from `at`."""
    bands = []
    for _ in range(3):
        data, left = [], n
        while left > 0:
            if at >= len(blob):
                break
            b = blob[at]
            at += 1
            if b & 0x80:
                run = b - 125
                data.append(blob[at:at + 1] * run)
                at += 1
            else:
                run = b + 1
                data.append(blob[at:at + run])
                at += run
            left -= run
        if left != 0:
            raise ValueError(f"{path}: ICNS: Error reading channel "
                             f"[{left} left]")
        band = b"".join(data)
        if len(band) < n:
            raise ValueError(f"{path}: ICNS: not enough image data")
        bands.append(np.frombuffer(band, np.uint8, n))
    return np.stack(bands, -1)


def _payload(blob: bytes, start: int, length: int, sizes, path: str
             ) -> np.ndarray:
    """read_png_or_jpeg2000, then convert("RGB"); the decoded size must
    be one the file lists, as IcnsImageFile's size setter checks."""
    from . import images
    sig = blob[start:start + 12]
    if sig.startswith(images.PNG_SIGNATURE):
        rgb = images.decode_png(blob[start:], path)
    elif sig.startswith(b"\xff\x4f\xff\x51") or \
            sig == jpeg2000.JP2_SIGNATURE:
        rgb = jpeg2000.decode_jpeg2000(blob[start:start + length], path)
    else:
        raise ValueError(f"{path}: ICNS: Unsupported icon subimage format")
    h, w = rgb.shape[:2]
    if not any(sw * sc // w == sh * sc / h for sw, sh, sc in sizes):
        raise ValueError(f"{path}: ICNS: This is not one of the allowed "
                         "sizes of this image")
    return rgb


def decode_icns(blob: bytes, path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the best size, as Pillow's convert("RGB")."""
    entries, sizes, best = _best(blob, path)
    w, h = best[0] * best[2], best[1] * best[2]
    rgb = payload = None
    for code, kind in SIZES[best]:          # dataforsize reads them all
        if code not in entries:
            continue
        start, length = entries[code]
        if kind == _PAYLOAD:
            payload = _payload(blob, start, length, sizes, path)
            continue
        if kind == _MASK:
            if len(blob) - start < w * h:
                raise ValueError(f"{path}: ICNS: not enough image data in "
                                 f"the mask {code.decode()}")
            continue
        if kind == _RLE_T:
            if blob[start:start + 4] != b"\0\0\0\0":
                raise ValueError(f"{path}: ICNS: Unknown signature, "
                                 "expecting 0x00000000")
            start, length = start + 4, length - 4
        if length == w * h * 3:
            if len(blob) - start < length:
                raise ValueError(f"{path}: ICNS: not enough image data")
            rgb = np.frombuffer(blob, np.uint8, length, start).reshape(
                h, w, 3)
        else:
            rgb = _rle(blob, start, w * h, path).reshape(h, w, 3)
    if payload is not None:
        return payload
    if rgb is None:                          # getimage's KeyError
        raise ValueError(f"{path}: ICNS: a mask without its icon")
    return np.ascontiguousarray(rgb)
