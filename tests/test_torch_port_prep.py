"""Data prep in the port (data/prep.py, cli/prep_pipeline.py --inp_dir,
data/resample.py) against the JAX package's and Pillow, on the CPU.

- resample.resize equals Pillow's Image.resize(..., LANCZOS) at several
  sizes, odd extents and scales, up and down;
- process_one and prep.main over a mixed dump (PNG variants, JPEG, BMP,
  PNM, RGBA, grey, palette, a too-small image, a corrupt file) keep and
  skip what the JAX package does, with the same pixels, a "skipping PATH:"
  line for each file neither can read, and the same cache listing;
- cli.prep_pipeline --inp_dir over the committed fixtures
  (l3c_torch/data/fixtures/prep) gives the kept lists and output pixels
  that expected.json records, and expected.json equals what Pillow and
  the JAX package give now: each fixture's mode and pixel digest, the JAX
  pipeline's kept lists and digests, and the optimized-PNG byte counts of
  chip_smoke's 8 bench images (these only under expected.json's zlib);
  the port decodes the rate fixture (l3c_torch/data/fixtures/rate, one
  1024 x 768 baseline JPEG for chip_smoke's prep rates) to Pillow's
  pixels. chip_smoke.py's phase prep holds the port to the same file on
  the card machine, which has no Pillow.

    python tests/test_torch_port_prep.py     # rewrites the fixtures

regenerates the fixtures (seeded numpy arrays written by Pillow, the
Adam7 and 16-bit PNGs by hand) and expected.json.
"""
import contextlib
import hashlib
import io
import json
import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "prep")
RATE = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "rate")
MIN_RES = 160


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _photo(h, w, seed, noise=2):
    """Smooth photo-like content: a few sinusoids a channel, mid-range
    values (prep's HSV filter keeps it), a little noise."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 37.0
    out = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(4):
            fy, fx, ph = r.uniform(0.05, 0.6, 3)
            out[..., c] += r.uniform(10, 30) * np.sin(
                6 * (fy * yy + fx * xx + ph))
    out += r.uniform(60, 140, 3)
    if noise:
        out += r.randint(-noise, noise + 1, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _photo_textured(h, w, seed):
    """_photo with texture at three scales (seeded noise fields, upsampled
    bilinearly) and sensor-like noise: a q90 JPEG of it codes at ~1.3 bits
    a pixel, as a photograph does."""
    r = np.random.RandomState(seed)
    out = _photo(h, w, seed, noise=0).astype(np.float64)
    for cell, amp in ((64, 18), (16, 10), (4, 6)):
        g = r.normal(0, 1, (h // cell + 2, w // cell + 2, 3))
        g = ((g - g.min()) / (g.max() - g.min()) * 255).astype(np.uint8)
        up = np.asarray(Image.fromarray(g).resize((w, h), Image.BILINEAR),
                        np.float64)
        out += amp * (up / 255 - 0.5) * 2
    out += r.normal(0, 3, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _png_bytes(samples, depth, interlace):
    """A colour-type-2 PNG of (h, w, 3) samples at `depth`, Paeth rows,
    non-interlaced or Adam7 (Pillow writes neither 16-bit RGB from numpy
    nor interlaced PNG)."""
    h, w, _ = samples.shape
    bpp = 3 * depth // 8
    passes = ([(0, 0, 1, 1)] if not interlace else
              [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)])
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        ph = sub.shape[0]
        rows = (sub.astype(">u2").view(np.uint8) if depth == 16
                else sub.astype(np.uint8)).reshape(ph, -1).astype(np.int32)
        up = np.zeros_like(rows)
        up[1:] = rows[:-1]
        left = np.zeros_like(rows)
        left[:, bpp:] = rows[:, :-bpp]
        ul = np.zeros_like(rows)
        ul[1:] = left[:-1]
        pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
        filt = np.concatenate([np.full((ph, 1), 4), (rows - pred) & 255], 1)
        raw += filt.astype(np.uint8).tobytes()

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def make_fixtures(d):
    """Write the fixture images into `d` (names sort in the order the
    pipeline splits them: the first goes to val)."""
    os.makedirs(d, exist_ok=True)
    for name, q, ss, extra in [("a_444_q90", 90, 0, {}),
                               ("b_420_q50", 50, 2, {}),
                               ("c_420_q85_rst", 85, 2,
                                {"restart_marker_blocks": 4}),
                               ("d_422_q75", 75, 1, {}),
                               ("e_444_q30", 30, 0, {}),
                               ("f_422_q95", 95, 1, {})]:
        Image.fromarray(_photo(208, 256, q)).save(
            os.path.join(d, name + ".jpg"), quality=q, subsampling=ss,
            **extra)
    Image.fromarray(_photo(208, 240, 7)[..., 1]).save(
        os.path.join(d, "g_grey_q80.jpg"), quality=80)
    Image.fromarray(_photo(120, 160, 8)).save(
        os.path.join(d, "h_progressive.jpg"), quality=80, progressive=True)
    buf = io.BytesIO()
    Image.fromarray(_photo(208, 256, 9)).save(buf, "JPEG", quality=90)
    with open(os.path.join(d, "i_truncated.jpg"), "wb") as f:
        f.write(buf.getvalue()[:len(buf.getvalue()) // 2])
    hi = _photo(200, 224, 10, noise=0).astype(np.uint16)
    with open(os.path.join(d, "j_rgb16.png"), "wb") as f:
        f.write(_png_bytes(hi * 256 + (hi * 7 & 255), 16, 0))
    with open(os.path.join(d, "k_adam7.png"), "wb") as f:
        f.write(_png_bytes(_photo(208, 240, 11, noise=0), 8, 1))
    Image.fromarray(_photo(64, 64, 12)).quantize(colors=16).save(
        os.path.join(d, "l_palette.png"))
    Image.fromarray(_photo(64, 64, 13)[..., 0]).save(
        os.path.join(d, "m_grey.png"))


def make_rate_fixture(d):
    """The rate fixture: one photograph-sized baseline JPEG (4:2:0, q90)."""
    os.makedirs(d, exist_ok=True)
    Image.fromarray(_photo_textured(768, 1024, 20)).save(
        os.path.join(d, "p_1024x768_q90.jpg"), quality=90)


def bench_images():
    """chip_smoke.bench_images(): bench.py's recipe, 8 of 512 x 512."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:512, 0:512]
    base = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1)
    draw = lambda: np.clip(base + rng.randint(-8, 8, base.shape), 0,
                           255).astype(np.uint8)
    draw()
    return [draw() for _ in range(8)]


def pillow_png_size(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", optimize=True)
    return buf.tell()


def _listing(out_root):
    """{sub: {name: pixel digest}} of a pipeline's output."""
    from l3c_tpu.data.images import load_image_uint8
    return {sub: {n: digest(load_image_uint8(os.path.join(out_root, sub, n)))
                  for n in sorted(os.listdir(os.path.join(out_root, sub)))}
            for sub in ("train", "val")}


def _pillow_entry(p):
    """A file's mode, size and pixel digest as Pillow opens it, or the
    reason the port refuses it."""
    with Image.open(p) as im:
        entry = {"mode": im.mode, "size": list(im.size[::-1])}
        try:
            entry["sha256"] = digest(np.asarray(im.convert("RGB")))
        except OSError as e:
            entry["refused"] = "truncated"
            entry["pillow"] = str(e)
    return entry


def expected_pixels_now(tmp):
    """expected.json's content but the PNG byte counts, as Pillow and the
    JAX package give it."""
    from l3c_tpu.cli import prep_pipeline as jpipe
    files = {n: _pillow_entry(os.path.join(FIXTURES, n))
             for n in sorted(os.listdir(FIXTURES)) if n != "expected.json"}
    rate = {n: _pillow_entry(os.path.join(RATE, n))
            for n in sorted(os.listdir(RATE))}
    out = os.path.join(tmp, "jax_out")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jpipe.main(["--inp_dir", FIXTURES, out, "--min_res",
                           str(MIN_RES)]) == 0
    return {"min_res": MIN_RES, "files": files, "rate": rate,
            "prep": _listing(out)}


def expected_png_bytes_now():
    """expected.json's optimized-PNG byte counts, under this zlib."""
    return {"classic_png_bytes": [pillow_png_size(im)
                                  for im in bench_images()],
            "zlib": zlib.ZLIB_RUNTIME_VERSION}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


# ----------------------------------------------------------------- tests

def test_expected_json_equals_pillow_and_jax_now(tmp_path):
    want = _expected()
    got = expected_pixels_now(str(tmp_path))
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(d, n))
               for d in (FIXTURES, RATE) for n in os.listdir(d)) < 300_000
    kinds = {n: v.get("refused") for n, v in want["files"].items()}
    assert sum(n.endswith(".jpg") for n in kinds) == 9
    assert not kinds["h_progressive.jpg"] and kinds["i_truncated.jpg"]
    assert want["prep"]["val"] and len(want["prep"]["train"]) >= 6
    assert [e["size"] for e in want["rate"].values()] == [[768, 1024]]


def test_expected_png_bytes_equal_pillow_now():
    """The byte counts depend on zlib's deflate: held under the zlib that
    recorded them."""
    want = _expected()
    got = expected_png_bytes_now()
    if got["zlib"] != want["zlib"]:
        pytest.skip(f"zlib {got['zlib']} here; expected.json's byte counts "
                    f"are {want['zlib']}'s")
    assert got == {k: want[k] for k in got}


def test_port_decodes_the_fixtures_as_expected():
    from l3c_torch.data import images as timages
    exp = _expected()
    for d, n, e in [(FIXTURES, n, e) for n, e in exp["files"].items()] + [
            (RATE, n, e) for n, e in exp["rate"].items()]:
        p = os.path.join(d, n)
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        if "refused" in e:
            with pytest.raises(ValueError, match="truncated"):
                timages.load_image_uint8(p)
        else:
            assert digest(timages.load_image_uint8(p)) == e["sha256"], n


def test_prep_pipeline_inp_dir_gives_the_expected_outputs(tmp_path,
                                                          capsys):
    """The by-source split, the kept lists, the output pixels and the
    cache listing of cli.prep_pipeline --inp_dir equal the JAX
    pipeline's (expected.json, held to it above); the truncated JPEG is
    skipped with a "skipping PATH:" line by both."""
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_torch.cli import prep_pipeline as tpipe
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    assert tpipe.main(["--inp_dir", FIXTURES, t_out, "--min_res",
                       str(MIN_RES)]) == 0
    t_cap = capsys.readouterr()
    assert _listing(t_out) == _expected()["prep"]
    assert jpipe.main(["--inp_dir", FIXTURES, j_out, "--min_res",
                       str(MIN_RES)]) == 0
    j_cap = capsys.readouterr()
    assert t_cap.out.splitlines()[:2] == j_cap.out.splitlines()[:2]
    skip = lambda err: [ln.split(": ")[0] for ln in err.splitlines()
                        if ln.startswith("skipping ")]
    assert skip(t_cap.err) == skip(j_cap.err) == [
        f"skipping {os.path.join(FIXTURES, 'i_truncated.jpg')}"]
    caches = [pickle.load(open(os.path.join(o, "cache.pkl"), "rb"))
              for o in (t_out, j_out)]
    rel = lambda c, o: {os.path.relpath(k[0], o): [os.path.relpath(p, o)
                                                   for p in v]
                        for k, v in c.items()}
    assert rel(caches[0], t_out) == rel(caches[1], j_out)


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (31, 17), (257, 383)])
@pytest.mark.parametrize("scale", [0.11, 0.5, 0.61, 0.8, 1.3])
def test_lanczos_equals_pillow(hw, scale):
    from l3c_torch.data.resample import resize
    img = np.random.RandomState(hw[1]).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    size = (max(1, round(hw[1] * scale)), max(1, round(hw[0] * scale)))
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize(img, size), want)
    grey = img[..., 0]
    want = np.asarray(Image.fromarray(grey).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize(grey, size), want)


def _dump(d):
    """A mixed dump: what prep keeps and every reason it skips."""
    os.makedirs(d)
    big = _photo(260, 230, 1)
    Image.fromarray(big).save(os.path.join(d, "rgb.png"))
    Image.fromarray(big).save(os.path.join(d, "jpeg.jpg"), quality=85)
    Image.fromarray(big).save(os.path.join(d, "bmp.bmp"))
    Image.fromarray(big).save(os.path.join(d, "pnm.ppm"))
    Image.fromarray(np.dstack([big, big[..., :1]])).save(
        os.path.join(d, "rgba.png"))
    Image.fromarray(big[..., 0]).save(os.path.join(d, "grey.png"))
    Image.fromarray(big).quantize(colors=8).save(os.path.join(d, "pal.png"))
    Image.fromarray(_photo(150, 300, 2)).save(os.path.join(d, "small.png"))
    Image.fromarray(np.full((230, 230, 3), 250, np.uint8)).save(
        os.path.join(d, "bright.png"))                    # HSV discard
    with open(os.path.join(d, "rgb16.png"), "wb") as f:
        f.write(_png_bytes(big.astype(np.uint16) * 257, 16, 0))
    with open(os.path.join(d, "corrupt.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + bytes(40))
    return d


def test_process_one_and_main_equal_jax(tmp_path, capsys):
    from l3c_tpu.data import prep as jprep
    from l3c_torch.data import prep as tprep
    from l3c_torch.data.images import read_png
    dump = _dump(str(tmp_path / "dump"))
    os.makedirs(str(tmp_path / "t"))
    os.makedirs(str(tmp_path / "j"))
    for i, n in enumerate(sorted(os.listdir(dump))):
        p = os.path.join(dump, n)
        t = tprep.process_one((p, str(tmp_path / "t"), MIN_RES, i))
        j = jprep.process_one((p, str(tmp_path / "j"), MIN_RES, i))
        err = capsys.readouterr().err
        assert (t is None) == (j is None), n
        assert err.count(f"skipping {p}: ") == (2 if n == "corrupt.png"
                                                else 0), (n, err)
        if t is not None:
            np.testing.assert_array_equal(
                read_png(t), np.asarray(Image.open(j).convert("RGB")))
    kept = sorted(os.listdir(str(tmp_path / "t")))
    assert kept == ["bmp.png", "jpeg.png", "pnm.png", "rgb.png", "rgb16.png"]
    # main: the port with two worker processes, JAX's with one
    assert tprep.main([dump, str(tmp_path / "tm"), "--min_res",
                       str(MIN_RES), "--workers", "2", "--update_cache",
                       str(tmp_path / "t.pkl")]) == 0
    assert jprep.main([dump, str(tmp_path / "jm"), "--min_res",
                       str(MIN_RES), "--workers", "1", "--update_cache",
                       str(tmp_path / "j.pkl")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(" in ")[0] == lines[2].split(" in ")[0] == \
        "kept 5/11 images"
    t_c = pickle.load(open(str(tmp_path / "t.pkl"), "rb"))
    j_c = pickle.load(open(str(tmp_path / "j.pkl"), "rb"))
    assert [os.path.basename(p) for v in t_c.values() for p in v] == \
        [os.path.basename(p) for v in j_c.values() for p in v]
    for n in os.listdir(str(tmp_path / "jm")):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "tm" / n)),
            np.asarray(Image.open(str(tmp_path / "jm" / n)).convert("RGB")))


def test_pipeline_refusals(tmp_path):
    from l3c_torch.cli import prep_pipeline as tpipe
    with pytest.raises(SystemExit):
        tpipe.main([str(tmp_path)])


@pytest.mark.parametrize("extra", [False, True])
def test_offline_synth_families_equal_jax(tmp_path, monkeypatch, capsys,
                                          extra):
    """--offline --synth_families 3 --synth_tiles 2 in both packages, with
    no corpus package installed (both modules' _SP an empty directory) and
    with and without --extra_train_dirs: the same [synth] line, the same
    x_synth_* tiles in train/ with the same pixels, the same cache
    listing."""
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_tpu.data import offline_corpus as joc
    from l3c_torch.cli import prep_pipeline as tpipe
    from l3c_torch.data import offline_corpus as toc
    from l3c_torch.data.images import read_png, write_png
    empty = tmp_path / "no_packages"
    empty.mkdir()
    monkeypatch.setattr(joc, "_SP", str(empty))
    monkeypatch.setattr(toc, "_SP", str(empty))
    args = ["--synth_families", "3", "--synth_tiles", "2", "--tile", "64"]
    if extra:
        xd = tmp_path / "extra"
        xd.mkdir()
        write_png(str(xd / "mine.png"), np.full((64, 64, 3), 7, np.uint8))
        args += ["--extra_train_dirs", str(xd)]
    outs = {}
    for tag, main in (("t", tpipe.main), ("j", jpipe.main)):
        out = tmp_path / tag
        assert main(["--offline", str(out)] + args) == 0
        lines = capsys.readouterr().out.splitlines()
        synth_line = [ln for ln in lines if ln.startswith("[synth]")]
        assert synth_line == [f"[synth] 6 tiles across 3 families -> "
                              f"{out / 'synth'}"]
        train = sorted(os.listdir(str(out / "train")))
        cache = pickle.load(open(str(out / "cache.pkl"), "rb"))
        outs[tag] = (train, [sorted(map(os.path.basename, v))
                             for v in cache.values()])
    assert outs["t"] == outs["j"]
    train = outs["t"][0]
    assert train == sorted((["x_mine.png"] if extra else []) + [
        f"x_synth_{f}_{t:04d}.png" for f in ("spectral", "terrain", "aniso")
        for t in range(2)])
    for n in train:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "t" / "train" / n)),
            np.asarray(Image.open(str(tmp_path / "j" / "train" / n))))


if __name__ == "__main__":
    import tempfile
    sys.path.insert(0, ROOT)
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    make_fixtures(FIXTURES)
    make_rate_fixture(RATE)
    with tempfile.TemporaryDirectory() as tmp:
        exp = {**expected_pixels_now(tmp), **expected_png_bytes_now()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} fixtures and expected.json "
          f"to {FIXTURES}")
