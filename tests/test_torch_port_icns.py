"""The port's ICNS reader (data/icns.py) against Pillow's IcnsImagePlugin,
which the JAX package's load_image_uint8 reads Apple icons through.

- Pillow's ICNS saves (PNG payloads at every size, the best a 1024 x 1024
  at scale 2), from RGB, RGBA and grey images;
- a test-only writer's files: it32 + t8mk, ih32 + h8mk, il32 + l8mk and
  is32 + s8mk in Apple's per-channel RLE (runs and literals of every
  length, across rows) and raw; a JPEG 2000 payload (JP2 and raw
  codestream) in ic08 and icp5; a PNG payload smaller than its slot;
  several sizes at once, so that Pillow's `bestsize` choice (the largest
  (width, height, scale), scale last) is held; repeated entries (the later
  wins);
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size from the header equal to Pillow's. Files Pillow
refuses (an RLE channel that overruns or ends early, a mask cut short, a
mask without its icon, an unknown payload, a payload of a size the file
does not list) raise ValueError in the port.
"""
import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402
from test_torch_port_jpeg2000_coding import content  # noqa: E402


def rle(plane: np.ndarray, seed: int = 0) -> bytes:
    """Apple's RLE of one channel: runs of 3 to 130 equal bytes (header
    n + 125) and literals of 1 to 128 (header n - 1), cut at seeded
    lengths."""
    r = np.random.RandomState(seed)
    v = plane.ravel().tobytes()
    out, at = [], 0
    while at < len(v):
        run = 1
        while at + run < len(v) and v[at + run] == v[at] and run < 130:
            run += 1
        if run >= 3:
            run = min(run, int(r.randint(3, 131)))
            out.append(bytes([run + 125, v[at]]))
            at += run
            continue
        n = min(len(v) - at, int(r.randint(1, 129)))
        out.append(bytes([n - 1]) + v[at:at + n])
        at += n
    return b"".join(out)


def rgb_entry(img: np.ndarray, raw: bool = False, t32: bool = False,
              seed: int = 0) -> bytes:
    """An it32 / ih32 / il32 / is32 body: three RLE channels (or the raw
    interleaved pixels), it32's behind four zero bytes."""
    if raw:
        body = img.tobytes()
    else:
        body = b"".join(rle(img[..., c], seed + c) for c in range(3))
    return (b"\0\0\0\0" if t32 else b"") + body


def icns(entries) -> bytes:
    """An ICNS file of (type, body) entries, in order."""
    blob = b"".join(struct.pack(">4sI", t, 8 + len(b)) + b
                    for t, b in entries)
    return b"icns" + struct.pack(">I", 8 + len(blob)) + blob


def posterised(h, w, seed):
    """Content with runs (RLE's runs) and noise (its literals)."""
    img = content(h, w, seed)
    img[: h // 2] = img[: h // 2] // 64 * 64
    return img


def _png(img) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "PNG")
    return f.getvalue()


def _j2k(img, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG2000", **kw)
    return f.getvalue()


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_pillow_icns_equals_pillow(tmp_path, mode):
    p = str(tmp_path / "x.icns")
    img = Image.fromarray(posterised(40, 40, 1)).convert(mode)
    img.save(p, "ICNS")
    check(p)
    assert timages.image_size(p) == (1024, 1024)


@pytest.mark.parametrize("case", ["it32", "ih32", "il32", "is32",
                                  "it32_raw", "is32_raw", "ih32_no_mask"])
def test_rle_icons_equal_pillow(tmp_path, case):
    code = case[:4].encode()
    side = {b"it32": 128, b"ih32": 48, b"il32": 32, b"is32": 16}[code]
    mask = {b"it32": b"t8mk", b"ih32": b"h8mk", b"il32": b"l8mk",
            b"is32": b"s8mk"}[code]
    img = posterised(side, side, side)
    body = rgb_entry(img, raw=case.endswith("raw"), t32=code == b"it32",
                     seed=side)
    entries = [(code, body)]
    if not case.endswith("no_mask"):
        entries.append((mask, content(side, side, 3)[..., 0].tobytes()))
    check(_write(tmp_path, "x.icns", icns(entries)))


@pytest.mark.parametrize("case", [
    "ic08_jp2", "icp5_j2k", "ic07_png_small", "ic08_jp2_small",
    "best_of_three", "scale_last", "repeated", "payload_beats_rle"])
def test_payloads_and_best_size_equal_pillow(tmp_path, case):
    small = posterised(16, 16, 2)
    if case == "ic08_jp2":
        entries = [(b"is32", rgb_entry(small)),
                   (b"ic08", _j2k(content(256, 256, 4), irreversible=True,
                                  quality_layers=[40]))]
    elif case == "icp5_j2k":
        entries = [(b"icp5", _j2k(content(32, 32, 5), no_jp2=True))]
    elif case == "ic07_png_small":
        entries = [(b"ic07", _png(content(64, 64, 6)))]
    elif case == "ic08_jp2_small":
        entries = [(b"ic08", _j2k(content(64, 64, 7)))]
    elif case == "best_of_three":
        entries = [(b"is32", rgb_entry(small)),
                   (b"it32", rgb_entry(posterised(128, 128, 8), t32=True)),
                   (b"ih32", rgb_entry(posterised(48, 48, 9)))]
    elif case == "scale_last":    # (48, 48, 1) beats (32, 32, 2)
        entries = [(b"ic12", _png(content(64, 64, 10))),
                   (b"ih32", rgb_entry(posterised(48, 48, 11)))]
    elif case == "repeated":
        entries = [(b"is32", rgb_entry(small)),
                   (b"is32", rgb_entry(posterised(16, 16, 12)))]
    else:
        entries = [(b"is32", rgb_entry(small)),
                   (b"icp4", _png(content(16, 16, 13))),
                   (b"s8mk", bytes(256))]
    check(_write(tmp_path, "x.icns", icns(entries)))


@pytest.mark.parametrize("case", ["overrun", "short", "mask_short",
                                  "mask_only", "unknown_payload",
                                  "payload_size", "it32_signature"])
def test_what_pillow_refuses_the_port_refuses(tmp_path, case):
    img = posterised(16, 16, 3)
    body = rgb_entry(img)
    if case == "overrun":
        entries = [(b"is32", bytes([130 + 125, 7]) + body)]
    elif case == "short":
        entries = [(b"is32", body[:len(body) // 3])]
    elif case == "mask_short":
        entries = [(b"is32", body), (b"s8mk", bytes(100))]
    elif case == "mask_only":
        entries = [(b"s8mk", bytes(256))]
    elif case == "unknown_payload":
        entries = [(b"icp4", b"GIF89a" + bytes(40))]
    elif case == "payload_size":
        entries = [(b"icp4", _png(content(12, 10, 4)))]
    else:
        entries = [(b"it32", b"\0\0\0\1" + rgb_entry(
            posterised(128, 128, 5)))]
    p = _write(tmp_path, "x.icns", icns(entries))
    with pytest.raises(Exception):
        jimages.load_image_uint8(p)
    with pytest.raises(ValueError, match="ICNS"):
        timages.load_image_uint8(p)
