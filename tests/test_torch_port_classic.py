"""The port's classical anchor (l3c_torch/eval/classic.py, cli/classic.py)
against the JAX package's, on the CPU.

- .medl v1 (static histogram), v2 (contexts) and v3 (contexts and the
  inter-channel correction) files byte-identical to the JAX package's on
  seeded images: odd sizes, 1 and 3 channels, a constant image, noise;
- each package decodes the other's files to the source pixels;
- the TSGD tables, the histogram quantizer and the MED predictor equal
  JAX's;
- the optimized-PNG column (eval.classic.png_size, no Pillow) equals the
  size of Pillow's optimize=True PNG, on seeded arrays and corpus images;
- cli.classic prints JAX's CLI's line (.medl and PNG bpsp) for the same
  PNGs, with zlib's version, and with --no_png JAX's .medl-only line.
"""
import os

import numpy as np
import pytest

from l3c_tpu.cli import classic as jcli
from l3c_tpu.eval import classic as jclassic
from l3c_torch.cli import classic as tcli
from l3c_torch.data.images import write_png
from l3c_torch.eval import classic as tclassic


def _structured(h, w, c, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1)[..., :c]
    return np.clip(base + rng.randint(-8, 8, base.shape), 0,
                   255).astype(np.uint8)


IMAGES = {
    "structured 37x53x3": lambda: _structured(37, 53, 3, 0),
    "structured 19x64x1": lambda: _structured(19, 64, 1, 1),
    "noise 23x17x3": lambda: np.random.RandomState(2).randint(
        0, 256, (23, 17, 3)).astype(np.uint8),
    "constant 16x16x3": lambda: np.full((16, 16, 3), 77, np.uint8),
    "one pixel": lambda: np.array([[[3, 200, 17]]], np.uint8),
}


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("version", [1, 2, 3])
def test_medl_bytes_equal_jax_and_cross_decode(name, version):
    img = IMAGES[name]()
    if version == 1:
        t, j = tclassic.encode_static(img), jclassic.encode_static(img)
    else:
        t = tclassic.encode(img, version)
        j = jclassic.encode(img, version)
    assert t == j
    assert t[2] == version
    np.testing.assert_array_equal(tclassic.decode(j), img)
    np.testing.assert_array_equal(jclassic.decode(t), img)
    np.testing.assert_array_equal(tclassic.decode(t), img)


def test_models_equal_jax():
    for theta in (0, 1, 77, 255):
        for p0 in (0, 128, 255):
            assert np.array_equal(tclassic._tsgd_cum(theta, p0),
                                  jclassic._tsgd_cum(theta, p0))
    rng = np.random.RandomState(0)
    res = rng.geometric(0.2, 5000).astype(np.int32) & 255
    assert tclassic._fit_tsgd(res) == jclassic._fit_tsgd(res)
    counts = np.bincount(res, minlength=256)
    assert np.array_equal(tclassic._quantize_hist(counts),
                          jclassic._quantize_hist(counts))
    plane = _structured(9, 11, 1, 3)[..., 0]
    assert np.array_equal(tclassic._med_pred_plane(plane),
                          jclassic._med_pred_plane(plane))
    img = _structured(40, 40, 3, 4)
    assert tclassic.bpsp(img) == jclassic.bpsp(img) < 6.0


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="uint8"):
        tclassic.encode(np.zeros((4, 4, 3), np.int32))
    with pytest.raises(ValueError, match="version"):
        tclassic.encode(np.zeros((4, 4, 3), np.uint8), version=1)
    with pytest.raises(ValueError, match="not a .medl"):
        tclassic.decode(b"\x00\x00\x03" + bytes(16))


PNG_IMAGES = dict(IMAGES, **{
    "structured 200x300x3": lambda: _structured(200, 300, 3, 5),
    "noise 150x120x3": lambda: np.random.RandomState(6).randint(
        0, 256, (150, 120, 3)).astype(np.uint8),
    "blocks 61x47x3": lambda: np.repeat(np.repeat(
        np.random.RandomState(7).randint(0, 256, (16, 12, 3)), 4, 0), 4,
        1)[:61, :47].astype(np.uint8),
})
CORPUS = ("sklearn/datasets/images/china.jpg",
          "gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
          "textures/metal1.png")


def _pillow_png_size(img):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", optimize=True)
    return buf.tell()


@pytest.mark.parametrize("name", list(PNG_IMAGES) + list(CORPUS))
def test_png_size_equals_pillow_optimize(name):
    """Exact byte counts: the filter choice, deflate's settings and the
    IDAT chunking all show in them (metal1's stream spans 5 chunks)."""
    if name in CORPUS:
        import sysconfig
        from l3c_torch.data.images import load_image_uint8
        p = os.path.join(sysconfig.get_paths()["purelib"], name)
        if not os.path.isfile(p):
            pytest.skip(f"corpus source {name} is not installed")
        img = load_image_uint8(p)
    else:
        img = PNG_IMAGES[name]()
    if img.shape[-1] == 1:
        img = img[..., 0]
    assert tclassic.png_size(img) == _pillow_png_size(img)


def test_cli_requires_no_png_and_matches_jax(tmp_path, capsys):
    """Without --no_png the port prints the JAX CLI's line, its PNG column
    included, and the zlib version; with it the .medl column alone."""
    import zlib
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(37, 53), (24, 20)]):
        write_png(str(d / f"im{i}.png"), _structured(h, w, 3, 10 + i))
    assert tcli.main([str(d)]) == 0
    port = capsys.readouterr().out.strip()
    assert jcli.main([str(d)]) == 0
    jax_line = capsys.readouterr().out.strip()
    assert "png_bpsp=" in jax_line
    assert port.startswith(jax_line + f" zlib={zlib.ZLIB_RUNTIME_VERSION}"
                           " enc+dec_ms=")
    assert tcli.main(["--no_png", str(d)]) == 0
    port = capsys.readouterr().out.strip()
    assert jcli.main(["--no_png", str(d)]) == 0
    jax_line = capsys.readouterr().out.strip()
    assert port.startswith(jax_line + " enc+dec_ms=")
    assert f"{d}: n=2 med_bpsp=" in port and "png_bpsp" not in port
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcli.main(["--no_png", str(empty)]) == 0
    assert "no images" in capsys.readouterr().err
