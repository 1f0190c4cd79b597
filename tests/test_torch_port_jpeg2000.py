"""The port's JPEG 2000 decoder (data/jpeg2000.py, data/jpeg2000_t1.py)
against Pillow, which the JAX package's load_image_uint8 decodes JP2 files
and raw codestreams through (OpenJPEG 2.5 under Jpeg2KImagePlugin).

- files Pillow's save writes, across its options: reversible (5/3) and
  irreversible (9/7), quality layers in rates and in dB, the five
  progression orders, 1 to 6 resolutions, code-block and precinct sizes,
  tiles with odd tile and image offsets, MCT on and off, signed samples,
  PLT, raw codestreams (no_jp2);
- modes L, LA, RGB, RGBA and I;16 at sizes that are not powers of two;
- files cut short: the port raises ValueError where Pillow raises
  ("broken data stream") and gives Pillow's pixels where Pillow reads;
- prep (cli.prep_pipeline --inp_dir) over an RGB JP2 named .jpg gives the
  JAX prep's outputs;
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
the format, mode and size from the header equal to Pillow's. What Pillow's
save cannot write is in test_torch_port_jpeg2000_coding.py.

l3c_torch/data/fixtures/jpeg2000 holds what chip_smoke.py's phase
jpeg2000 decodes on the card machine, with expected.json (Pillow's
formats, modes, sizes and pixel digests, the JAX listing, the library
versions); `python tests/test_torch_port_jpeg2000.py` (from the repo root,
PYTHONPATH=.) rewrites them.
"""
import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np
import PIL
import PIL.features
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402
from test_torch_port_jpeg2000_coding import content  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "jpeg2000")
LISTING_MIN_SIZE = 90
# coded by chip_smoke's cli.l3c and timed for the host decode rates
CODED = ("c_rate_lossy.jp2", "d_rate_lossless.j2k")


def _save(tmp_path, img, name="x.jp2", mode=None, **kw):
    p = str(tmp_path / name)
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(p, "JPEG2000", **kw)
    return p


OPTIONS = {
    "lossless": {},
    "lossy": dict(irreversible=True),
    "rates_53": dict(quality_mode="rates", quality_layers=[40, 20, 5]),
    "rates_97": dict(quality_mode="rates", quality_layers=[60, 30, 10],
                     irreversible=True),
    "db_53": dict(quality_mode="dB", quality_layers=[30, 40, 50]),
    "db_97": dict(quality_mode="dB", quality_layers=[25, 35],
                  irreversible=True),
    "cblk_4x4": dict(codeblock_size=(4, 4), quality_layers=[20, 0]),
    "cblk_8x32": dict(codeblock_size=(8, 32), irreversible=True),
    "cblk_64x16": dict(codeblock_size=(64, 16)),
    "precincts_32": dict(precinct_size=(32, 32), progression="RPCL",
                         quality_layers=[30, 10, 0]),
    "precincts_32x64": dict(precinct_size=(32, 64), progression="PCRL",
                            irreversible=True, quality_layers=[30, 10]),
    "tiles": dict(tile_size=(16, 24), tile_offset=(3, 5), offset=(7, 9)),
    "tiles_97": dict(tile_size=(20, 16), tile_offset=(1, 2), offset=(3, 3),
                     irreversible=True, quality_layers=[20]),
    "offset_odd": dict(offset=(5, 3), tile_offset=(1, 2),
                       tile_size=(64, 64)),
    "mct0": dict(mct=0),
    "mct0_97": dict(mct=0, irreversible=True),
    "signed": dict(signed=True),
    "signed_97": dict(signed=True, irreversible=True),
    "plt": dict(plt=True, quality_layers=[20, 0]),
    "no_jp2": dict(no_jp2=True),
    "no_jp2_97": dict(no_jp2=True, irreversible=True, quality_layers=[30]),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_pillow_save_options_equal_pillow(tmp_path, option):
    check(_save(tmp_path, content(61, 53, 2), **OPTIONS[option]))


@pytest.mark.parametrize("prog", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_precinct_exponent_0_refused_as_pillow_refuses(tmp_path, prog):
    """Pillow halves the precinct size at each lower resolution; 16 x 16
    over six resolutions reaches 1 x 1 above the lowest one, which
    OpenJPEG refuses to read."""
    p = _save(tmp_path, content(40, 36, 6), precinct_size=(16, 16),
              progression=prog)
    assert not _outcome_equal(p)


@pytest.mark.parametrize("prog", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("irreversible", [False, True])
def test_progressions_equal_pillow(tmp_path, prog, irreversible):
    check(_save(tmp_path, content(50, 47, 3), progression=prog,
                irreversible=irreversible, quality_layers=[40, 15, 5],
                precinct_size=(32, 32), codeblock_size=(16, 16)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_resolutions_equal_pillow(tmp_path, n):
    check(_save(tmp_path, content(40, 44, n), num_resolutions=n,
                irreversible=n % 2 == 0))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("hw", [(1, 1), (3, 7), (29, 33), (128, 96)])
def test_modes_and_sizes_equal_pillow(tmp_path, mode, hw):
    img = content(*hw, hw[0] + hw[1])
    if mode in ("LA", "RGBA"):
        img = np.dstack([img, img[..., :1] ^ 0x3C])
    kw = {} if min(hw) < 8 else dict(irreversible=hw[0] == 128)
    check(_save(tmp_path, img, mode=mode, **kw))


@pytest.mark.parametrize("no_jp2", [False, True])
def test_i16_equals_pillow(tmp_path, no_jp2):
    img = content(29, 35, 4)[..., 0].astype(np.uint16)
    p = str(tmp_path / "x.j2k")
    Image.fromarray(img * 150 + 7).save(p, "JPEG2000", no_jp2=no_jp2)
    assert timages.image_mode(p) == "I;16"
    check(p)


def _outcome_equal(p):
    """Both raise (the port ValueError), or both give the same pixels."""
    try:
        want = jimages.load_image_uint8(p)
    except OSError:
        with pytest.raises(ValueError, match="broken data stream"):
            timages.load_image_uint8(p)
        return False
    np.testing.assert_array_equal(timages.load_image_uint8(p), want)
    return True


@pytest.mark.parametrize("kind", ["lossless", "lossy", "tiled", "raw"])
def test_truncated_files_refused_where_pillow_refuses(tmp_path, kind):
    kw = {"lossless": {}, "lossy": dict(irreversible=True),
          "tiled": dict(tile_size=(16, 16), progression="RPCL",
                        quality_layers=[30, 10, 0]),
          "raw": dict(no_jp2=True, tile_size=(24, 24))}[kind]
    with open(_save(tmp_path, content(48, 40, 5), **kw), "rb") as f:
        blob = f.read()
    n = len(blob)
    cuts = [n // 2, n - 3, n - 2, n - 1]
    at = blob.find(b"\xff\x90", n // 3)         # a tile-part's SOT
    cuts += [at, at + 2, at + 5] if kind in ("tiled", "raw") else []
    read = []
    for k, cut in enumerate(cuts):
        p = str(tmp_path / f"cut{k}.jp2")
        with open(p, "wb") as f:
            f.write(blob[:cut])
        read.append(_outcome_equal(p))
    assert read[:4] == [False] * 4     # cut in data, in EOC, without EOC
    if kind in ("tiled", "raw"):
        assert read[5]                 # a lone last SOT: the tiles before


def test_prep_inp_dir_over_a_jp2_named_jpg_equals_jax(tmp_path, capsys):
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_torch.cli import prep_pipeline as tpipe
    from test_torch_port_prep import _photo
    dump = tmp_path / "dump"
    dump.mkdir()
    Image.fromarray(_photo(260, 230, 3)).save(str(dump / "photo.jpg"),
                                              "JPEG2000", irreversible=True)
    Image.fromarray(_photo(210, 220, 4)).save(str(dump / "raw.png"),
                                              "JPEG2000", no_jp2=True)
    outs = []
    for main, name in ((tpipe.main, "t"), (jpipe.main, "j")):
        out = str(tmp_path / name)
        assert main(["--inp_dir", str(dump), out, "--min_res", "160"]) == 0
        outs.append(out)
    capsys.readouterr()
    listing = lambda o: sorted(os.path.relpath(os.path.join(b, f), o)
                               for b, _, fs in os.walk(o) for f in fs
                               if f.endswith(".png"))
    assert listing(outs[0]) == listing(outs[1]) and listing(outs[0])
    for rel in listing(outs[0]):
        np.testing.assert_array_equal(
            timages.read_png(os.path.join(outs[0], rel)),
            np.asarray(Image.open(os.path.join(outs[1], rel)).convert(
                "RGB")))


# ------------------------------------------------------------- fixtures

def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def make_jpeg2000_fixtures(d, tmp):
    """The phase's files: two files the listing keeps (a JP2 named .png,
    a raw codestream named .jpg), the rate files (256 x 256 9/7 at about
    1 bit a pixel, 128 x 128 5/3 lossless), Pillow's tiled RPCL with
    precincts and three layers, L, LA, RGBA and 12-bit grey, and the
    test-only writer's: all six code-block style bits, SOP + EPH + TLM +
    PLT, sYCC 4:2:0, CMYK, a palette, ROI; two ICNS files; a truncated
    file and a Part-1 codestream marked as HTJ2K, which both refuse."""
    from test_torch_port_icns import icns, posterised, rgb_entry
    from test_torch_port_jpeg2000_coding import encode, htj2k, jp2
    from test_torch_port_prep import _photo, _photo_textured
    os.makedirs(d, exist_ok=True)

    def save(name, img, mode=None, **kw):
        im = Image.fromarray(img)
        (im.convert(mode) if mode else im).save(os.path.join(d, name),
                                                "JPEG2000", **kw)

    def put(name, blob):
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    save("a_jp2_as.png", _photo(96, 128, 1), irreversible=True,
         quality_layers=[12])
    save("b_j2k_as.jpg", _photo(80, 112, 2), no_jp2=True)
    save("c_rate_lossy.jp2", _photo_textured(256, 256, 3), irreversible=True,
         quality_mode="rates", quality_layers=[24])
    save("d_rate_lossless.j2k", _photo_textured(128, 128, 4), no_jp2=True)
    save("e_tiled_rpcl.jp2", _photo(72, 80, 5), tile_size=(32, 32),
         tile_offset=(3, 1), offset=(5, 7), progression="RPCL",
         num_resolutions=4, precinct_size=(16, 16),
         quality_layers=[40, 15, 0])
    save("f_grey.jp2", _photo(40, 52, 6), "L")
    img = _photo(44, 36, 7)
    save("g_la.jp2", np.dstack([img, img[..., :1] ^ 0x5A]), "LA",
         irreversible=True)
    save("h_rgba.jp2", np.dstack([img, img[..., 1:2] // 2]),
         irreversible=True, quality_layers=[20, 8])
    w = lambda *a, **k: encode(*a, path=os.path.join(tmp, "w.j2k"), **k)
    img = _photo(40, 48, 8)
    put("i_grey12.j2k", w([img[..., 0].astype(np.int64) * 16],
                          (0, 0, 48, 40), prec=12, levels=3))
    rgb = [img[..., c] for c in range(3)]
    put("j_styles.j2k", w(rgb, (0, 0, 48, 40), mode=63, cblk=(16, 16),
                          rates=(20, 6, 0)))
    put("k_sop_eph_tlm_plt.j2k", w(rgb, (0, 0, 48, 40), csty=6,
                                   rates=(20, 0), tiles=(0, 0, 32, 32),
                                   extra=("TLM=YES", "PLT=YES")))
    put("l_sycc420.jp2", jp2(w([img[..., 0], img[::2, ::2, 1],
                                img[::2, ::2, 2]], (0, 0, 48, 40),
                               dx=[1, 2, 2], dy=[1, 2, 2], levels=3), 18))
    put("m_cmyk.jp2", jp2(w(rgb + [img[..., 0] // 3], (0, 0, 48, 40),
                            levels=3), 12))
    pal = np.random.RandomState(9).randint(0, 256, (32, 3))
    put("n_palette.jp2", jp2(w([img[..., 1] // 8], (0, 0, 48, 40),
                               levels=3), 16, pclr=pal))
    put("o_roi.j2k", w(rgb, (0, 0, 48, 40), roi=(0, 5), irreversible=True,
                       rates=(12,)))
    y, x = np.mgrid[0:40, 0:40]
    flat = np.stack([np.where(x < 20, 200, 40), np.where(y < 20, 180, 60),
                     np.full((40, 40), 120)], -1).astype(np.uint8)
    Image.fromarray(flat).save(os.path.join(d, "p_pillow.icns"), "ICNS")
    f = io.BytesIO()
    Image.fromarray(_photo(64, 64, 10)).save(f, "JPEG2000",
                                             irreversible=True)
    put("q_rle_jpeg2000.icns", icns([
        (b"it32", rgb_entry(posterised(128, 128, 11), t32=True)),
        (b"t8mk", bytes(128 * 128)), (b"ic08", f.getvalue())]))
    with open(os.path.join(d, "e_tiled_rpcl.jp2"), "rb") as f:
        tiled = f.read()
    put("r_truncated.jp2", tiled[:len(tiled) // 2])
    put("s_htj2k.j2k", htj2k(w(rgb, (0, 0, 48, 40), levels=3)))


# files Pillow refuses: what the port's refusal says
_PORT_REFUSES = {"r_truncated.jp2": "tile-part longer than the file",
                 "s_htj2k.j2k": "We do not support more than 3 coding "
                                "passes in an HT codeblock"}


def jpeg2000_expected_now():
    """expected.json's content as Pillow and the JAX package give it."""
    files = {}
    for n in sorted(os.listdir(FIXTURES)):
        if n == "expected.json":
            continue
        p = os.path.join(FIXTURES, n)
        with Image.open(p) as im:
            e = {"format": im.format, "mode": im.mode,
                 "size": list(im.size[::-1])}
        try:
            e["sha256"] = _digest(jimages.load_image_uint8(p))
        except OSError as err:
            e["pillow_refuses"] = str(err).split(" (")[0]
            e["port"] = _PORT_REFUSES[n]
        files[n] = e
    listing = jimages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE)
    return {"files": files, "listing_min_size": LISTING_MIN_SIZE,
            "listing": [os.path.basename(p) for p in listing.paths()],
            "tested": [os.path.basename(p)
                       for p in jimages.iter_images_in(FIXTURES)],
            "coded": list(CODED)}


def _versions():
    return {"pillow": PIL.__version__,
            "openjpeg": PIL.features.version("jpg_2000"),
            "zlib": PIL.features.version("zlib")}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def test_jpeg2000_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    got = jpeg2000_expected_now()
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 400_000
    assert want["tested"] == ["a_jp2_as.png", "b_j2k_as.jpg"]
    assert want["listing"] == ["a_jp2_as.png"]


def test_port_reads_the_jpeg2000_fixtures_as_expected():
    for n, e in _expected()["files"].items():
        p = os.path.join(FIXTURES, n)
        assert timages.image_format(p) == e["format"], n
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        if "refused" in e:
            with pytest.raises(ValueError, match=f"{e['refused']} is not "
                               "decoded by the port yet"):
                timages.load_image_uint8(p)
        elif "pillow_refuses" in e:
            with pytest.raises(ValueError, match="broken data stream") as err:
                timages.load_image_uint8(p)
            assert e["port"] in str(err.value), n
        else:
            assert _digest(timages.load_image_uint8(p)) == e["sha256"], n
    got = timages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE).paths()
    assert [os.path.basename(p) for p in got] == _expected()["listing"]


if __name__ == "__main__":
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    with tempfile.TemporaryDirectory() as tmp:
        make_jpeg2000_fixtures(FIXTURES, tmp)
    exp = {**jpeg2000_expected_now(), "made_by": _versions()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
