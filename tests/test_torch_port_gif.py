"""The port's GIF reader (data/gif.py) against Pillow, which the JAX
package's load_image_uint8 reads GIF through (GifImagePlugin, GifDecode.c,
then convert("RGB")).

- files Pillow writes: palettes of 2 to 256 colours, grey, transparency,
  interlaced and not, sizes down to 1 x 1, an animation's first frame,
  and a GIF saved under a .png name;
- files a test-only writer makes: global and local palettes, the grey
  ramp Pillow reads as mode "L", no palette at all, a first frame placed
  at an offset or reaching past the logical screen (which then grows),
  transparency filling the canvas, interlace at every height up to 17,
  LZW code sizes 2 to 8, a stream without a leading clear, a table that
  fills up without a clear (a deferred clear), no end code at all,
  indices past the palette;
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
the mode and size from the header equal to Pillow's. A file cut short
in its image data, an end code before the frame is complete and code
size 1 raise in both packages.
"""
import io
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import gif as tgif
from l3c_torch.data import images as timages


def check(p):
    """The port's pixels, mode and size equal Pillow's and the JAX
    loader's."""
    with Image.open(p) as im:
        fmt, mode, size = im.format, im.mode, im.size[::-1]
        want = np.asarray(im.convert("RGB"))
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimages.load_image_uint8(p))
    assert timages.image_format(p) == fmt
    assert timages.image_mode(p) == mode
    assert timages.image_size(p) == size


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


# ------------------------------------------------------------ the writer

def lzw_encode(idx, bits, clear_first=True, full="clear", end=True):
    """GIF LZW of the indices at minimum code size `bits`: codes LSB
    first; the decoder adds each entry one code later than the encoder,
    so the encoder widens its codes after adding entry 2^n, the decoder
    after adding entry 2^n - 1.
    full="clear" emits a clear code when the table fills, "defer" keeps
    coding 12-bit codes with a full table."""
    clear, eoi = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([v]): v for v in range(clear)}, eoi + 1, bits + 1

    table, nxt, size = reset()
    if clear_first:
        emit(clear, size)
    w = b""
    for v in bytes(idx):
        wc = w + bytes([v])
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        if nxt < 4096:
            table[wc] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        elif full == "clear":
            emit(clear, size)
            table, nxt, size = reset()
        w = bytes([v])
    if w:
        emit(table[w], size)
    if end:
        if nxt == 1 << size and size < 12:    # the decoder widened first
            size += 1
        emit(eoi, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def make_gif(screen, frame, idx, *, glob=None, local=None, trans=None,
             interlace=False, bits=8, version=b"GIF89a", lzw=None):
    """A GIF with one image: screen (w, h), frame (x0, y0, w, h), its
    indices in data order, palettes as (n, 3) arrays (n a power of 2)."""
    out = bytearray(version + struct.pack("<HH", *screen))
    flags = 0
    if glob is not None:
        flags = 0x80 | (len(glob).bit_length() - 2)
    out += bytes([flags, 0, 0])
    if glob is not None:
        out += np.asarray(glob, np.uint8).tobytes()
    if trans is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, trans]) + b"\0"
    out += b"!\xfe" + _blocks(b"a comment")
    fl = 0x40 if interlace else 0
    if local is not None:
        fl |= 0x80 | (len(local).bit_length() - 2)
    out += b"," + struct.pack("<HHHH", *frame) + bytes([fl])
    if local is not None:
        out += np.asarray(local, np.uint8).tobytes()
    out += bytes([bits]) + _blocks(lzw if lzw is not None
                                   else lzw_encode(idx, bits))
    return bytes(out + b";")


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


def _idx(n, k, seed, smooth=False):
    r = np.random.RandomState(seed)
    if smooth:
        return (np.cumsum(r.randint(0, 2, n)) // 7 % k).astype(np.uint8)
    return r.randint(0, k, n).astype(np.uint8)


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("colours", [2, 7, 16, 100, 256])
@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (31, 47), (70, 90)])
def test_pillow_palette_gifs_equal_pillow(tmp_path, hw, colours):
    r = np.random.RandomState(hw[0] * 7 + colours)
    img = np.cumsum(r.randint(0, 40, hw + (3,)), 1).astype(np.uint8)
    p = str(tmp_path / "p.gif")
    Image.fromarray(img).quantize(colours).save(p)
    check(p)


@pytest.mark.parametrize("kw", [{}, {"interlace": False},
                                {"transparency": 3}, {"optimize": False}])
@pytest.mark.parametrize("mode", ["L", "P", "1"])
def test_pillow_gifs_of_each_mode_equal_pillow(tmp_path, mode, kw):
    r = np.random.RandomState(len(mode) + len(kw))
    img = Image.fromarray(r.randint(0, 256, (37, 53, 3)).astype(np.uint8))
    p = str(tmp_path / "m.gif")
    img.convert(mode).save(p, **kw)
    check(p)


def test_animation_gives_its_first_frame(tmp_path):
    r = np.random.RandomState(5)
    frames = [Image.fromarray(r.randint(0, 256, (24, 30, 3)).astype(
        np.uint8)).quantize(32) for _ in range(3)]
    p = str(tmp_path / "a.gif")
    frames[0].save(p, save_all=True, append_images=frames[1:], duration=40,
                   loop=0)
    check(p)


def test_mislabelled_gif_is_read_by_its_bytes(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (20, 26, 3)).astype(
        np.uint8)
    p = str(tmp_path / "really_a_gif.png")
    Image.fromarray(img).quantize(40).save(p, format="GIF")
    check(p)
    assert timages.image_format(p) == "GIF"


@pytest.mark.parametrize("case", ["global", "local", "both", "grey_global",
                                  "grey_local", "none", "short_palette"])
def test_palettes_equal_pillow(tmp_path, case):
    w, h = 23, 17
    idx = _idx(w * h, 16, 3)
    grey = np.repeat(np.arange(16)[:, None], 3, 1)
    kw = {"global": dict(glob=_palette(16, 1)),
          "local": dict(local=_palette(16, 2)),
          "both": dict(glob=_palette(16, 1), local=_palette(16, 2)),
          "grey_global": dict(glob=grey),
          "grey_local": dict(glob=_palette(16, 1), local=grey),
          "none": {},
          "short_palette": dict(glob=_palette(4, 4))}[case]
    check(_write(tmp_path, f"{case}.gif", make_gif((w, h), (0, 0, w, h), idx,
                                                   **kw)))


@pytest.mark.parametrize("frame", [(3, 2, 10, 9), (0, 0, 5, 5),
                                   (20, 15, 12, 9), (30, 0, 4, 4)])
@pytest.mark.parametrize("trans", [None, 5])
def test_frame_placement_and_transparency_equal_pillow(tmp_path, frame,
                                                       trans):
    """The first frame at an offset on the canvas (grown where the frame
    reaches past the screen), the rest index 0 or the transparent
    index."""
    idx = _idx(frame[2] * frame[3], 8, sum(frame))
    check(_write(tmp_path, "f.gif", make_gif((24, 18), frame, idx,
                                             glob=_palette(8, 9),
                                             trans=trans)))


@pytest.mark.parametrize("h", list(range(1, 18)))
def test_interlace_at_every_height_equals_pillow(tmp_path, h):
    w = 5
    rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])
    img = _idx(w * h, 32, h).reshape(h, w)
    check(_write(tmp_path, "i.gif", make_gif(
        (w, h), (0, 0, w, h), img[rows].ravel(), glob=_palette(32, h),
        interlace=True)))


@pytest.mark.parametrize("bits", range(2, 9))
def test_code_sizes_equal_pillow(tmp_path, bits):
    """Minimum code sizes 2 to 8."""
    w, h = 40, 33
    idx = _idx(w * h, 1 << bits, bits, smooth=bits > 4)
    check(_write(tmp_path, "b.gif", make_gif((w, h), (0, 0, w, h), idx,
                                             glob=_palette(1 << bits, bits),
                                             bits=bits)))


@pytest.mark.parametrize("how", ["no_clear", "defer", "no_end",
                                 "past_palette", "gif87a"])
def test_lzw_edge_cases_equal_pillow(tmp_path, how):
    w, h = 64, 80                    # 5120 pixels of noise fill the table
    idx = _idx(w * h, 200, 11)
    kw = dict(glob=_palette(256, 12))
    if how == "no_clear":
        kw["lzw"] = lzw_encode(idx, 8, clear_first=False)
    elif how == "defer":
        kw["lzw"] = lzw_encode(idx, 8, full="defer")
    elif how == "no_end":
        kw["lzw"] = lzw_encode(idx, 8, end=False)
    elif how == "past_palette":
        kw["glob"] = _palette(64, 12)
    else:
        kw["version"] = b"GIF87a"
    check(_write(tmp_path, f"{how}.gif", make_gif((w, h), (0, 0, w, h), idx,
                                                  **kw)))


@pytest.mark.parametrize("how", ["cut", "early_end", "code_size_1"])
def test_truncated_data_is_refused_by_both(tmp_path, how):
    """Data cut short, an end code before the frame is complete, and code
    size 1 (whose 2-bit codes never widen in GifDecode.c, so the stream
    runs out): both packages refuse; the header still gives the size."""
    w, h = 30, 30
    idx = _idx(w * h, 200, 4)
    if how == "code_size_1":
        blob = make_gif((w, h), (0, 0, w, h), idx % 2, glob=_palette(2, 4),
                        bits=1)
    elif how == "early_end":
        blob = make_gif((w, h), (0, 0, w, h), idx, glob=_palette(256, 4),
                        lzw=lzw_encode(idx[:w * h // 2 + 7], 8))
    else:
        blob = make_gif((w, h), (0, 0, w, h), idx, glob=_palette(256, 4))
        blob = blob[:len(blob) // 2]
    p = _write(tmp_path, "t.gif", blob)
    with pytest.raises(ValueError, match="GIF"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError):
        jimages.load_image_uint8(p)
    assert timages.image_size(p) == (h, w)


def test_decode_rate_is_reported():
    """Not a gate: the pure-Python LZW's rate on a 200 x 200 noise GIF."""
    f = io.BytesIO()
    img = np.random.RandomState(0).randint(0, 256, (200, 200, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(f, "GIF")
    t = time.perf_counter()
    px = tgif.decode_gif(f.getvalue())
    dt = time.perf_counter() - t
    assert px.shape == (200, 200, 3)
    print(f"GIF decode {0.04 / dt:.2f} MP/s on this CPU")
