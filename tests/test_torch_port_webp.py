"""The port's WebP decoder (data/webp.py) against Pillow, which the JAX
package's load_image_uint8 decodes through (libwebp's WebPAnimDecoder).

- lossy (VP8) files written by Pillow at qualities 0 to 100 and methods 0
  to 6, odd sizes down to 1 x 1, noise and smooth content;
- lossy files written through the system libwebp's advanced API by a
  test-only C helper (skipped where libwebp's headers or a C compiler are
  absent): the simple and the normal loop filter at several strengths and
  sharpnesses, 1, 2, 4 and 8 token partitions, 1 to 4 segments;
- lossy with alpha (VP8X + ALPH, the alpha with zeros), whose RGB Pillow
  gives unpremultiplied;
- lossless (VP8L) at methods 0 to 6 and qualities 0 to 100 (the
  predictor, cross-colour and subtract-green transforms, the colour cache,
  meta prefix codes), palettes of 2, 4, 16 and 256 colours (colour indexing
  with pixel bundling), with alpha and `exact`;
- extended files with ICC and EXIF chunks;
every pixel equal to Pillow's convert("RGB") and to
l3c_tpu.data.images.load_image_uint8, and the mode and size from the
headers equal to Pillow's; an animation gives its first frame on the
canvas. A truncated file raises ValueError with the reason.
`python tests/test_torch_port_webp.py` rewrites the formats fixtures
(l3c_torch/data/fixtures/formats and formats_rate) and their
expected.json.
"""
import contextlib
import ctypes
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import PIL
import PIL.features
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "formats")
FORMATS_RATE = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                            "formats_rate")
FORMATS_MIN_RES = 96
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_prep import _photo, _photo_textured, digest  # noqa


def content(h, w, seed, kind):
    r = np.random.RandomState(seed)
    if kind == "noise":
        return r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 7 % 256, xx * 3 % 256, (yy * xx) % 256], -1)
    return np.clip(base + r.randint(-20, 20, base.shape), 0,
                   255).astype(np.uint8)


def check(p):
    """The port's pixels, mode and size equal Pillow's and the JAX
    loader's."""
    with Image.open(p) as im:
        mode, size = im.mode, im.size[::-1]
        want = np.asarray(im.convert("RGB"))
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimages.load_image_uint8(p))
    assert timages.image_mode(p) == mode
    assert timages.image_size(p) == size


SIZES = [(1, 1), (2, 3), (17, 23), (33, 65)]


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("hw", SIZES)
def test_lossy_equals_pillow(tmp_path, hw, method):
    p = str(tmp_path / "l.webp")
    for q, kind in ((0, "noise"), (30, "smooth"), (75, "noise"),
                    (90, "smooth"), (100, "noise")):
        Image.fromarray(content(*hw, q + method, kind)).save(
            p, quality=q, method=method)
        check(p)
    assert timages.image_mode(p) == "RGB"


@pytest.mark.parametrize("method", [0, 2, 4, 6])
@pytest.mark.parametrize("hw", SIZES)
def test_lossless_equals_pillow(tmp_path, hw, method):
    p = str(tmp_path / "ll.webp")
    for q, kind in ((0, "noise"), (50, "smooth"), (100, "smooth"),
                    (100, "noise")):
        Image.fromarray(content(*hw, q + method, kind)).save(
            p, lossless=True, quality=q, method=method)
        check(p)


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 256])
def test_palettes_equal_pillow(tmp_path, colours):
    """Colour indexing: 8, 4, 2 and 1 pixels a packed pixel."""
    p = str(tmp_path / "pal.webp")
    for hw in ((1, 1), (5, 7), (33, 65)):
        img = content(*hw, colours, "noise" if colours < 20 else "smooth")
        rgb = Image.fromarray(img).quantize(colours).convert("RGB")
        for method in (0, 4, 6):
            rgb.save(p, lossless=True, method=method)
            check(p)


@pytest.mark.parametrize("kw", [dict(quality=60), dict(quality=100),
                                dict(lossless=True),
                                dict(lossless=True, exact=True)])
def test_alpha_equals_pillow(tmp_path, kw):
    """Alpha with zeros: the mode is RGBA, the RGB as Pillow gives it
    (libwebp's unpremultiplied output; with `exact` the RGB under zero
    alpha is kept)."""
    p = str(tmp_path / "a.webp")
    r = np.random.RandomState(3)
    for hw in ((1, 1), (17, 23), (33, 65)):
        a = r.randint(0, 256, hw).astype(np.uint8)
        a[:hw[0] // 2] = 0
        im = Image.fromarray(content(*hw, 1, "smooth")).convert("RGBA")
        im.putalpha(Image.fromarray(a))
        im.save(p, **kw)
        check(p)
        assert timages.image_mode(p) == "RGBA"


def test_extended_chunks_equal_pillow(tmp_path):
    """VP8X files with ICC and EXIF chunks around the image data."""
    p = str(tmp_path / "x.webp")
    img = Image.fromarray(content(17, 23, 0, "smooth"))
    exif = Image.Exif()
    exif[0x010E] = "a description"
    for kw in (dict(quality=80), dict(lossless=True)):
        img.save(p, icc_profile=b"\0" * 131, exif=exif.tobytes(), **kw)
        assert open(p, "rb").read(16)[12:16] == b"VP8X"
        check(p)


# ------------------------------------- libwebp's advanced encoder options

HELPER_C = r"""
#include <string.h>
#include <webp/encode.h>
/* rgb (h x w x 3) -> a lossy WebP in out (cap bytes); its size, 0 on
   error */
size_t encode(const uint8_t* rgb, int w, int h, float q, int method,
              int ftype, int sharp, int strength, int parts, int segs,
              int sns, uint8_t* out, size_t cap) {
  WebPConfig c;
  WebPPicture pic;
  WebPMemoryWriter wr;
  size_t n = 0;
  if (!WebPConfigInit(&c) || !WebPPictureInit(&pic)) return 0;
  c.quality = q; c.method = method; c.filter_type = ftype;
  c.filter_sharpness = sharp; c.filter_strength = strength;
  c.partitions = parts; c.segments = segs; c.sns_strength = sns;
  c.autofilter = 0;
  if (!WebPValidateConfig(&c)) return 0;
  pic.width = w; pic.height = h;
  if (!WebPPictureImportRGB(&pic, rgb, 3 * w)) return 0;
  WebPMemoryWriterInit(&wr);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &wr;
  if (WebPEncode(&c, &pic) && wr.size <= cap) {
    memcpy(out, wr.mem, wr.size);
    n = wr.size;
  }
  WebPPictureFree(&pic);
  WebPMemoryWriterClear(&wr);
  return n;
}
"""


@pytest.fixture(scope="module")
def libwebp_encoder(tmp_path_factory):
    """The helper compiled against the system libwebp; skips without its
    headers or a C compiler."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    d = tmp_path_factory.mktemp("webp_helper")
    src, lib = d / "helper.c", d / "helper.so"
    src.write_text(HELPER_C)
    r = subprocess.run([cc, "-O1", "-shared", "-fPIC", str(src), "-o",
                        str(lib), "-lwebp"], capture_output=True, text=True)
    if r.returncode:
        pytest.skip(f"the libwebp helper does not build (libwebp-dev "
                    f"absent?): {r.stderr[-300:]}")
    so = ctypes.CDLL(str(lib))
    so.encode.restype = ctypes.c_size_t
    so.encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float] + [ctypes.c_int] * 7 + [
                              ctypes.c_void_p, ctypes.c_size_t]

    def encode(img, q=75, method=4, ftype=1, sharp=0, strength=60, parts=0,
               segs=4, sns=50):
        img = np.ascontiguousarray(img)
        out = np.zeros(1 << 20, np.uint8)
        n = so.encode(img.ctypes.data, img.shape[1], img.shape[0], q, method,
                      ftype, sharp, strength, parts, segs, sns,
                      out.ctypes.data, out.size)
        assert n, "libwebp refused the options"
        return out[:n].tobytes()
    return encode


@pytest.mark.parametrize("ftype", [0, 1])
@pytest.mark.parametrize("sharp", [0, 3, 5, 7])
def test_loop_filters_equal_pillow(tmp_path, libwebp_encoder, ftype, sharp):
    """The simple (0) and the normal (1) loop filter, strengths from off to
    the strongest, every sharpness class."""
    p = str(tmp_path / "f.webp")
    for hw, strength, q in (((33, 65), 0, 50), ((33, 65), 30, 20),
                            ((40, 50), 100, 5), ((17, 23), 70, 60)):
        blob = libwebp_encoder(content(*hw, strength, "smooth"), q=q,
                               ftype=ftype, sharp=sharp, strength=strength)
        open(p, "wb").write(blob)
        check(p)


@pytest.mark.parametrize("parts", [0, 1, 2, 3])
@pytest.mark.parametrize("segs", [1, 2, 3, 4])
def test_partitions_and_segments_equal_pillow(tmp_path, libwebp_encoder,
                                              parts, segs):
    """1, 2, 4 and 8 token partitions (a 65-pixel-high frame has 5
    macroblock rows), 1 to 4 segments with their quantizers and filter
    levels."""
    p = str(tmp_path / "s.webp")
    for kind, q, sns in (("noise", 40, 100), ("smooth", 80, 70)):
        blob = libwebp_encoder(content(65, 47, q, kind), q=q, parts=parts,
                               segs=segs, sns=sns)
        open(p, "wb").write(blob)
        check(p)


@pytest.mark.parametrize("kw", [dict(quality=70), dict(lossless=True)])
@pytest.mark.parametrize("alpha", [False, True])
def test_animated_first_frame_equals_pillow(tmp_path, kw, alpha):
    """An animation (VP8X + ANIM + ANMF): Pillow's Image.open shows the
    first frame on the canvas."""
    p = str(tmp_path / "anim.webp")
    frames = [Image.fromarray(content(17, 23, s, "smooth")) for s in (0, 1)]
    if alpha:
        frames = [f.convert("RGBA") for f in frames]
        ramp = np.tile(np.arange(23, dtype=np.uint8) * 11, (17, 1))
        frames[0].putalpha(Image.fromarray(ramp))
    frames[0].save(p, save_all=True, append_images=frames[1:], duration=50,
                   **kw)
    with Image.open(p) as im:
        assert im.n_frames == 2
    check(p)


def test_what_is_not_decoded_raises_with_the_reason(tmp_path):
    """Truncated files, lossy and lossless: ValueError with the reason."""
    p = str(tmp_path / "t.webp")
    for kw in (dict(quality=80), dict(lossless=True)):
        buf = io.BytesIO()
        Image.fromarray(content(33, 65, 2, "noise")).save(buf, "WEBP", **kw)
        blob = buf.getvalue()
        for cut in (len(blob) // 2, len(blob) - 9, 30):
            open(p, "wb").write(blob[:cut])
            with pytest.raises(ValueError, match="truncated|corrupt"):
                timages.load_image_uint8(p)


# ------------------------------------------------------ formats fixtures


def _save(d, name, im, **kw):
    im.save(os.path.join(d, name), **kw)


def make_fixtures(d, rate_d):
    """The formats fixtures: each newly read kind at a size prep keeps
    (short side >= FORMATS_MIN_RES / 0.8), photo-like content; the rate
    fixtures apart."""
    os.makedirs(d, exist_ok=True)
    os.makedirs(rate_d, exist_ok=True)
    photo = lambda h, w, s: Image.fromarray(_photo(h, w, s))
    _save(d, "a_prog_420.jpg", photo(144, 176, 1), quality=85,
          progressive=True)
    _save(d, "b_prog_444_rst.jpg", photo(136, 160, 2), quality=92,
          progressive=True, subsampling=0, restart_marker_blocks=5)
    _save(d, "c_prog_grey.jpg", photo(128, 150, 3).convert("L"), quality=80,
          progressive=True)
    _save(d, "d_cmyk.jpg", photo(128, 144, 4).convert("CMYK"), quality=90)
    _save(d, "e_lossy.webp", photo(152, 168, 5), quality=80)
    rgba = photo(128, 136, 6).convert("RGBA")
    a = np.full((128, 136), 255, np.uint8)
    a[:40, :50] = 0
    rgba.putalpha(Image.fromarray(a))
    _save(d, "f_lossy_alpha.webp", rgba, quality=70)
    _save(d, "g_lossless.webp", photo(128, 160, 7), lossless=True)
    _save(d, "h_lossless_palette.webp", photo(136, 152, 8).quantize(
        16).convert("RGB"), lossless=True)
    _save(d, "i_grey8.bmp", photo(128, 140, 9).convert("L"))
    deep = (_photo(128, 132, 10).astype(np.uint16) * 257).byteswap()
    with open(os.path.join(d, "j_rgb16.ppm"), "wb") as f:
        f.write(b"P6\n132 128\n65535\n" + deep.tobytes())
    plain = _photo(120, 124, 11)
    with open(os.path.join(d, "k_ascii.ppm"), "wb") as f:
        f.write(b"P3\n# plain\n124 120\n255\n" + "\n".join(
            " ".join(map(str, row)) for row in plain.reshape(120, -1)
        ).encode() + b"\n")
    frames = [photo(128, 128, s) for s in (12, 13)]
    frames[0].save(os.path.join(d, "l_animated.webp"), save_all=True,
                   append_images=frames[1:], duration=40)
    big = Image.fromarray(_photo_textured(768, 1024, 21))
    _save(rate_d, "r_prog_1024x768_q90.jpg", big, quality=90,
          progressive=True)
    _save(rate_d, "s_lossy_1024x768_q80.webp", big, quality=80)
    _save(rate_d, "t_lossless_256x192.webp",
          Image.fromarray(_photo_textured(192, 256, 22)), lossless=True)


def _entry(p):
    """Pillow's mode, size and pixel digest of a file."""
    with Image.open(p) as im:
        return {"mode": im.mode, "size": list(im.size[::-1]),
                "sha256": digest(np.asarray(im.convert("RGB")))}


def expected_now(tmp):
    """expected.json's content as Pillow and the JAX pipeline give it."""
    from l3c_tpu.cli import prep_pipeline as jpipe
    files = {n: _entry(os.path.join(FORMATS, n))
             for n in sorted(os.listdir(FORMATS)) if n != "expected.json"}
    rate = {n: _entry(os.path.join(FORMATS_RATE, n))
            for n in sorted(os.listdir(FORMATS_RATE))}
    out = os.path.join(tmp, "jax_out")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jpipe.main(["--inp_dir", FORMATS, out, "--min_res",
                           str(FORMATS_MIN_RES)]) == 0
    prep = {sub: {n: digest(jimages.load_image_uint8(os.path.join(out, sub,
                                                                  n)))
                  for n in sorted(os.listdir(os.path.join(out, sub)))}
            for sub in ("train", "val")}
    return {"min_res": FORMATS_MIN_RES, "files": files, "rate": rate,
            "prep": prep}


def _versions():
    return {"pillow": PIL.__version__,
            "libjpeg_turbo": PIL.features.version_feature("libjpeg_turbo"),
            "libwebp": PIL.features.version("webp")}


def _expected():
    with open(os.path.join(FORMATS, "expected.json")) as f:
        return json.load(f)


def test_formats_expected_json_equals_pillow_and_jax_now(tmp_path):
    want = _expected()
    got = expected_now(str(tmp_path))
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(d, n))
               for d in (FORMATS, FORMATS_RATE)
               for n in os.listdir(d)) < 600_000
    kept = sorted(n for sub in want["prep"].values() for n in sub)
    assert kept == [os.path.splitext(n)[0] + ".png"
                    for n, e in sorted(want["files"].items())
                    if e["mode"] == "RGB"]


def test_port_decodes_the_format_fixtures_as_expected():
    exp = _expected()
    for d, n, e in [(FORMATS, n, e) for n, e in exp["files"].items()] + [
            (FORMATS_RATE, n, e) for n, e in exp["rate"].items()
            if not n.startswith("s_")]:
        p = os.path.join(d, n)
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        assert digest(timages.load_image_uint8(p)) == e["sha256"], n


def test_prep_pipeline_over_the_formats_gives_jax_outputs(tmp_path,
                                                          capsys):
    """cli.prep_pipeline --inp_dir keeps what the JAX pipeline keeps (the
    progressive JPEGs, the RGB WebPs and the animation's first frame, the
    16-bit and ASCII PNMs), with its pixels; both skip the grey, CMYK and
    RGBA files by their mode."""
    from l3c_torch.cli import prep_pipeline as tpipe
    out = str(tmp_path / "t")
    assert tpipe.main(["--inp_dir", FORMATS, out, "--min_res",
                       str(FORMATS_MIN_RES)]) == 0
    got = {sub: {n: digest(timages.load_image_uint8(os.path.join(out, sub,
                                                                 n)))
                 for n in sorted(os.listdir(os.path.join(out, sub)))}
           for sub in ("train", "val")}
    assert got == _expected()["prep"]
    assert "skipping" not in capsys.readouterr().err


if __name__ == "__main__":
    import tempfile
    for d in (FORMATS, FORMATS_RATE):
        for n in os.listdir(d) if os.path.isdir(d) else ():
            os.remove(os.path.join(d, n))
    make_fixtures(FORMATS, FORMATS_RATE)
    with tempfile.TemporaryDirectory() as tmp:
        exp = {**expected_now(tmp), "made_by": _versions()}
    with open(os.path.join(FORMATS, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} + {len(exp['rate'])} fixtures and "
          f"expected.json to {FORMATS}")
