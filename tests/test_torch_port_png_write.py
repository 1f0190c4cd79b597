"""The port's PNG writer (data/images.write_png) against Pillow's default
save, which every PNG the JAX package writes goes through (prep, the
offline corpus, the synth tiles, the tester's decoded files).

- 60 seeded arrays of 1 to 299 px a side (noise, smooth, posterized) and
  one 900 x 1200: the inflated image data (each row's filter byte and its
  filtered bytes) equal to Pillow's, both files cut into IDAT chunks of
  max(65536, 4 W) bytes but the last, and the whole files byte-equal
  where Pillow and Python's zlib module use one zlib (deflate's bytes are
  zlib's own);
- the optimized column (eval/classic.png_size) and write_png share the
  filter code: png_size's rows are Pillow's optimize=True rows;
- the port's prep and synth writers give Pillow's bytes for their
  pixels.
"""
import io
import os
import struct
import zlib

import numpy as np
import PIL.features
import pytest
from PIL import Image

from l3c_torch.data import images as timages
from l3c_torch.eval import classic as tclassic

SAME_ZLIB = PIL.features.version("zlib") == zlib.ZLIB_RUNTIME_VERSION


def _array(i: int) -> np.ndarray:
    """Seeded array i: 1 to 299 px a side; noise, smooth or posterized."""
    r = np.random.RandomState(1000 + i)
    h, w = r.randint(1, 300, 2)
    if i % 3 == 0:
        return r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 3 + xx, xx * 2 + 40, (yy + xx) // 2], -1)
    if i % 3 == 1:
        return np.clip(base + r.randint(-3, 4, base.shape), 0,
                       255).astype(np.uint8)
    return ((base // 64 * 64 + r.randint(0, 2, base.shape) * 32) % 256
            ).astype(np.uint8)


def _chunks(blob: bytes):
    """[(type, data)] of a PNG's chunks."""
    out, at = [], 8
    while at < len(blob):
        n, t = struct.unpack(">I4s", blob[at:at + 8])
        out.append((t, blob[at + 8:at + 8 + n]))
        at += 12 + n
    return out


def _pillow(img: np.ndarray, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "PNG", **kw)
    return f.getvalue()


def _hold(port: bytes, pil: bytes, w: int):
    cp, cq = _chunks(port), _chunks(pil)
    assert [t for t, _ in cp] == [t for t, _ in cq]
    assert cp[0] == cq[0]                               # IHDR
    idat_p = [d for t, d in cp if t == b"IDAT"]
    idat_q = [d for t, d in cq if t == b"IDAT"]
    block = max(65536, 4 * w)
    for idat in (idat_p, idat_q):
        assert all(len(d) == block for d in idat[:-1])
        assert 0 < len(idat[-1]) <= block
    assert zlib.decompress(b"".join(idat_p)) == \
        zlib.decompress(b"".join(idat_q))
    if SAME_ZLIB:
        assert port == pil


@pytest.mark.parametrize("i", range(60))
def test_writer_gives_pillows_default_save(tmp_path, i):
    img = _array(i)
    p = str(tmp_path / "w.png")
    timages.write_png(p, img)
    with open(p, "rb") as f:
        port = f.read()
    _hold(port, _pillow(img), img.shape[1])
    np.testing.assert_array_equal(timages.read_png(p), img)


def test_large_writer_gives_pillows_default_save(tmp_path):
    """900 x 1200: several IDAT chunks of 65536 bytes."""
    yy, xx = np.mgrid[0:900, 0:1200]
    r = np.random.RandomState(7)
    img = np.clip(np.stack([xx % 256, yy % 256, (xx * yy) % 251], -1)
                  + r.randint(0, 9, (900, 1200, 3)), 0, 255).astype(np.uint8)
    p = str(tmp_path / "big.png")
    timages.write_png(p, img)
    with open(p, "rb") as f:
        port = f.read()
    assert sum(t == b"IDAT" for t, _ in _chunks(port)) > 1
    _hold(port, _pillow(img), 1200)


@pytest.mark.parametrize("i", [0, 1, 2, 5])
def test_optimized_rows_are_pillows(i):
    """png_size filters with Average among the candidates, as Pillow's
    optimize=True: its rows are the inflated data of Pillow's file."""
    img = _array(i)
    rows = timages.png_filter_rows(img, timages.PNG_FILTERS_OPTIMIZE)
    pil = _pillow(img, optimize=True)
    assert zlib.decompress(b"".join(d for t, d in _chunks(pil)
                                    if t == b"IDAT")) == rows.tobytes()
    if SAME_ZLIB:
        assert tclassic.png_size(img) == len(pil)


def test_prep_and_synth_write_pillows_bytes(tmp_path):
    """Two of the writers that go through write_png: prep's output and a
    synth tile, each equal to Pillow's save of its own pixels."""
    from l3c_torch.data import prep, synth
    r = np.random.RandomState(3)
    src = str(tmp_path / "src.png")
    yy, xx = np.mgrid[0:60, 0:72]
    Image.fromarray(np.clip(np.stack([yy * 4, xx * 3, yy + xx], -1)
                            + r.randint(0, 30, (60, 72, 3)), 0, 255
                            ).astype(np.uint8)).save(src)
    out = tmp_path / "out"
    out.mkdir()
    assert prep.process_one((src, str(out), 32, 0)) is not None
    written = [str(out / n) for n in sorted(os.listdir(out))]
    tile = str(tmp_path / "tile.png")
    timages.write_png(tile, synth.render_tile(next(iter(synth.FAMILIES)),
                                              np.random.RandomState(0), 32))
    for p in written + [tile]:
        with open(p, "rb") as f:
            port = f.read()
        px = timages.read_png(p)
        _hold(port, _pillow(px), px.shape[1])
