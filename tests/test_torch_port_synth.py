"""The procedural source families in the port (data/synth.py) against the
JAX package's (l3c_tpu/data/synth.py, which calls scipy and Pillow), on
the CPU:

- render_tile of each of the 33 families equal, bit for bit, at n = 64
  for seeds 0-2 and at n = 256 for seed 1, the noise branch (camera
  noise, the JPEG round trip, uniform dither) included, with no JPEG
  block saturated on the way;
- generate_families' file names and pixels, and its skip of a file that
  exists; Pillow's bicubic x4 upsample (multiscale's coarse layer);
- the committed fixtures (l3c_torch/data/fixtures/synth) equal what the
  JAX package and Pillow give now, and the port renders them: the seed-1
  tile of each family and two jpegtex tiles (one JPEG round trip, two) as
  PNGs with their digests; a 200 x 136 cut of one through the JPEG round
  trip at q 8 and 90 (Pillow's file digests, the decoded pixels'); the
  pixel digests of what prep_pipeline --offline --synth_families 33
  --synth_tiles 2 writes; numpy's version and synth.numpy_probe().
  chip_smoke.py's phase synth holds the port to the same file on the card
  machine.

    python tests/test_torch_port_synth.py     # rewrites the fixtures
"""
import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import synth as js
from l3c_torch.data import images as timages
from l3c_torch.data import jpeg
from l3c_torch.data import jpeg_encode
from l3c_torch.data import synth as ts
from l3c_torch.data.resample import resize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "synth")
TILE_N, TILE_SEED = 256, 1
ROUNDTRIP_HW, ROUNDTRIP_Q = (136, 200), (8, 90)
PREP_TILES = 2


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@pytest.mark.parametrize("fam", list(js.FAMILIES))
def test_render_tile_equals_jax(fam):
    before = jpeg.COUNTS["saturated_blocks"]
    for n, seeds in ((64, (0, 1, 2)), (256, (TILE_SEED,))):
        for seed in seeds:
            want = js.render_tile(fam, np.random.RandomState(seed), n)
            got = ts.render_tile(fam, np.random.RandomState(seed), n)
            assert got.dtype == np.uint8 and got.shape == (n, n, 3)
            np.testing.assert_array_equal(got, want, err_msg=f"{fam} n={n} "
                                          f"seed={seed}")
    assert jpeg.COUNTS["saturated_blocks"] == before


def test_families_and_helpers_equal_jax():
    assert list(ts.FAMILIES) == list(js.FAMILIES)
    assert [f.__name__ for f in ts.FAMILIES.values()] == \
        [f.__name__ for f in js.FAMILIES.values()]
    rs = np.random.RandomState
    np.testing.assert_array_equal(
        ts._spectral_noise(rs(4), 48, 2.1, 3.0, 0.7),
        js._spectral_noise(rs(4), 48, 2.1, 3.0, 0.7))
    u8 = rs(9).randint(0, 256, (24, 24, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ts._camera_degrade(u8, rs(4)),
                                  js._camera_degrade(u8, rs(4)))
    fields = np.random.RandomState(2).normal(size=(3, 20, 20))
    np.testing.assert_array_equal(
        ts._rgb_mix(np.random.RandomState(5), fields, 0.7),
        js._rgb_mix(np.random.RandomState(5), fields, 0.7))
    np.testing.assert_array_equal(ts._smooth01(fields), js._smooth01(fields))


@pytest.mark.parametrize("hw", [(16, 16), (64, 64), (7, 5), (1, 1),
                                (2, 5)])
def test_bicubic_x4_upsample_equals_pillow(hw):
    """multiscale's coarse layer: Image.fromarray(u8).resize((4w, 4h),
    BICUBIC), on noise and on a ramp."""
    h, w = hw
    r = np.random.RandomState(h * w)
    for u8 in (r.randint(0, 256, (h, w, 3)).astype(np.uint8),
               np.repeat(np.linspace(0, 255, h * w).reshape(h, w, 1)
                         .astype(np.uint8), 3, 2)):
        want = np.asarray(Image.fromarray(u8).resize((4 * w, 4 * h),
                                                     Image.BICUBIC))
        np.testing.assert_array_equal(resize(u8, (4 * w, 4 * h), "bicubic"),
                                      want)


def test_generate_families_equals_jax(tmp_path):
    fams = ["spectral", "jpegtex", "hdrclip"]
    tp = ts.generate_families(str(tmp_path / "t"), 2, n=64, seed=3,
                              families=fams)
    jp = js.generate_families(str(tmp_path / "j"), 2, n=64, seed=3,
                              families=fams)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] == \
        [f"synth_{f}_{t:04d}.png" for f in fams for t in range(2)]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(timages.read_png(a),
                                      np.asarray(Image.open(b)))
    # an existing file is kept, not re-rendered; a larger tile count
    # renders only the new tiles, each from its own seed
    keep = np.zeros((64, 64, 3), np.uint8)
    timages.write_png(tp[0], keep)
    tp3 = ts.generate_families(str(tmp_path / "t"), 3, n=64, seed=3,
                               families=fams)
    jp3 = js.generate_families(str(tmp_path / "j"), 3, n=64, seed=3,
                               families=fams)
    np.testing.assert_array_equal(timages.read_png(tp[0]), keep)
    for a, b in zip(tp3[1:], jp3[1:]):
        np.testing.assert_array_equal(timages.read_png(a),
                                      np.asarray(Image.open(b)))


# -------------------------------------------------------------- fixtures


def _jpegtex_seeds():
    """The first seeds from 2 whose jpegtex family round-trips through
    JPEG once and twice (the double-compressed re-share): {seed: count}."""
    calls = []
    orig = js._jpeg_roundtrip
    js._jpeg_roundtrip = lambda u8, q: calls.append(q) or orig(u8, q)
    found = {}
    try:
        seed = 2
        while len(found) < 2:
            calls.clear()
            js._fam_jpegtex(np.random.RandomState(seed), TILE_N)
            if len(calls) not in found.values():
                found[seed] = len(calls)
            seed += 1
    finally:
        js._jpeg_roundtrip = orig
    return found


def pillow_jpeg(rgb, q):
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, format="JPEG", quality=q)
    return b.getvalue()


def expected_now(tmp):
    """(expected.json's content, {fixture PNG name: pixels}) from the JAX
    package, Pillow and this host's numpy."""
    pngs = {f"tile_{fam}.png": js.render_tile(
        fam, np.random.RandomState(TILE_SEED), TILE_N)
        for fam in js.FAMILIES}
    jt = {}
    for seed, k in _jpegtex_seeds().items():
        name = f"jpegtex_s{seed}.png"
        pngs[name] = js.render_tile("jpegtex", np.random.RandomState(seed),
                                    TILE_N)
        jt[name] = {"seed": seed, "family_roundtrips": k}
    h, w = ROUNDTRIP_HW
    src = np.ascontiguousarray(pngs["tile_shapes.png"][:h, :w])
    rt = {"from": "tile_shapes.png", "rows": h, "cols": w,
          "sha256": digest(src)}
    for q in ROUNDTRIP_Q:
        blob = pillow_jpeg(src, q)
        px = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        np.testing.assert_array_equal(js._jpeg_roundtrip(src, q), px)
        rt[str(q)] = {"jpeg_sha256": hashlib.sha256(blob).hexdigest(),
                      "jpeg_bytes": len(blob), "sha256": digest(px)}
    paths = js.generate_families(tmp, PREP_TILES, n=TILE_N)
    prep = {os.path.basename(p): digest(np.asarray(Image.open(p)))
            for p in paths}
    exp = {"numpy": np.__version__, "probe": ts.numpy_probe(),
           "n": TILE_N, "seed": TILE_SEED,
           "tiles": {n: digest(a) for n, a in sorted(pngs.items())},
           "jpegtex": jt, "roundtrip": rt,
           "prep": {"synth_tiles": PREP_TILES, "tile": TILE_N,
                    "sha256": prep}}
    return exp, pngs


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def test_fixtures_equal_jax_and_pillow_now(tmp_path):
    exp = _expected()
    now, pngs = expected_now(str(tmp_path))
    assert now == exp
    for name, arr in pngs.items():
        np.testing.assert_array_equal(
            timages.read_png(os.path.join(FIXTURES, name)), arr)


def test_port_renders_the_fixtures():
    """What chip_smoke's phase synth checks, on this host (whose numpy
    probe is the fixtures'): every tile bit for bit, the round trip's
    JPEG bytes Pillow's and its pixels Pillow's."""
    exp = _expected()
    assert ts.numpy_probe() == exp["probe"]
    for name, want in exp["tiles"].items():
        fam, seed = (("jpegtex", exp["jpegtex"][name]["seed"])
                     if name in exp["jpegtex"] else
                     (name[len("tile_"):-len(".png")], exp["seed"]))
        got = ts.render_tile(fam, np.random.RandomState(seed), exp["n"])
        assert digest(got) == want, name
        np.testing.assert_array_equal(
            got, timages.read_png(os.path.join(FIXTURES, name)))
    rt = exp["roundtrip"]
    src = timages.read_png(os.path.join(FIXTURES, rt["from"]))[
        :rt["rows"], :rt["cols"]]
    src = np.ascontiguousarray(src)
    assert digest(src) == rt["sha256"]
    for q in ROUNDTRIP_Q:
        blob = jpeg_encode.encode_jpeg(src, q)
        assert hashlib.sha256(blob).hexdigest() == rt[str(q)]["jpeg_sha256"]
        assert digest(ts._jpeg_roundtrip(src, q)) == rt[str(q)]["sha256"]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    os.makedirs(FIXTURES, exist_ok=True)
    for n in os.listdir(FIXTURES):
        os.remove(os.path.join(FIXTURES, n))
    with tempfile.TemporaryDirectory() as tmp:
        exp, pngs = expected_now(tmp)
    for name, arr in pngs.items():
        timages.write_png(os.path.join(FIXTURES, name), arr)
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(pngs)} tiles and expected.json to {FIXTURES}")
