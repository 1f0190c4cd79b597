"""The port's classical anchor (l3c_torch/eval/classic.py, cli/classic.py)
against the JAX package's, on the CPU.

- .medl v1 (static histogram), v2 (contexts) and v3 (contexts and the
  inter-channel correction) files byte-identical to the JAX package's on
  seeded images: odd sizes, 1 and 3 channels, a constant image, noise;
- each package decodes the other's files to the source pixels;
- the TSGD tables, the histogram quantizer and the MED predictor equal
  JAX's;
- cli.classic refuses to run without --no_png, naming the reason, and
  with it prints JAX's CLI's .medl bpsp for the same PNGs.
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


def test_cli_requires_no_png_and_matches_jax(tmp_path, capsys):
    d = tmp_path / "imgs"
    d.mkdir()
    for i, (h, w) in enumerate([(37, 53), (24, 20)]):
        write_png(str(d / f"im{i}.png"), _structured(h, w, 3, 10 + i))
    assert tcli.main([str(d)]) == 2
    err = capsys.readouterr().err
    assert "--no_png" in err and "Pillow" in err
    assert tcli.main(["--no_png", str(d)]) == 0
    port = capsys.readouterr().out.strip()
    assert jcli.main(["--no_png", str(d)]) == 0
    jax_line = capsys.readouterr().out.strip()
    assert port.startswith(jax_line + " enc+dec_ms=")
    assert f"{d}: n=2 med_bpsp=" in port
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcli.main(["--no_png", str(empty)]) == 0
    assert "no images" in capsys.readouterr().err
