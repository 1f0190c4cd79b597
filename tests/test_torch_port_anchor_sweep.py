"""`python -m l3c_torch.tools.anchor_sweep` against the JAX package's
`tools/anchor_sweep.py`: on a folder of seeded tiles (PNG, and a GIF and
a TIFF the port now reads), with and without --limit, the port's script
prints the JAX script's lines, estimates and the real v2 size included.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
from PIL import Image

import tools.anchor_sweep as jsweep
from l3c_torch.tools import anchor_sweep as tsweep


def _tiles(d):
    r = np.random.RandomState(0)
    for i, fmt in enumerate(["PNG", "PNG", "GIF", "TIFF", "PNG"]):
        h, w = r.randint(12, 40, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([yy * 5 + xx, xx * 3, (yy * xx) % 97], -1)
                      + r.randint(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(str(d / f"t{i}.{fmt.lower()}"), fmt)


def _run(main, argv):
    old, out = sys.argv, io.StringIO()
    sys.argv = ["anchor_sweep"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.mark.parametrize("limit", [None, 3])
def test_printed_lines_equal_jax(tmp_path, limit):
    _tiles(tmp_path)
    argv = [str(tmp_path)] + ([] if limit is None else ["--limit",
                                                        str(limit)])
    got = _run(tsweep.main, argv)
    assert got == _run(jsweep.main, argv)
    assert [line.split()[0] for line in got.splitlines()] == [
        "v2_real", "act8_est", "act16_est", "loco_est", "loco_ic_est"]
