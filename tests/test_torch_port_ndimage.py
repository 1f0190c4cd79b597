"""The port's scipy.ndimage stand-ins (data/ndimage.py) against scipy,
bitwise: map_coordinates at order 1 in the legacy "wrap" mode (period
n - 1) and in "reflect", at coordinates inside the input, on its last
cell [n - 1, n) and far outside it; gaussian_filter at the sigmas
data/synth.py draws (4 to 12) and a few more.
"""
import numpy as np
import pytest
from scipy import ndimage as sn

from l3c_torch.data import ndimage as tn

SHAPES = [(5, 5), (64, 64), (17, 33), (1, 7), (2, 9), (256, 256)]


def _coordinates(r, n0, n1):
    """(rows, cols) of one shape: inside, on the edges and the last cell,
    a little and far outside, and exact integers."""
    m = 48
    rows = r.uniform(0, n0 - 1, (m, m))
    cols = r.uniform(0, n1 - 1, (m, m))
    rows[0], cols[0] = np.linspace(n0 - 1, n0, m), np.linspace(n1 - 1, n1, m)
    rows[1], cols[1] = -np.linspace(0, 1, m), np.linspace(-1, n1 + 1, m)
    rows[2] = r.uniform(-3 * n0, 4 * n0, m)
    cols[2] = r.uniform(-3 * n1, 4 * n1, m)
    rows[3] = r.randint(-2 * n0, 3 * n0, m).astype(np.float64)
    cols[3] = r.randint(-2 * n1, 3 * n1, m).astype(np.float64)
    rows[4] = r.uniform(-1e3, 1e3, m)
    cols[4] = (np.arange(m) % 4) * 0.5 + n1 - 1.5
    return rows, cols


@pytest.mark.parametrize("mode", ["wrap", "reflect"])
@pytest.mark.parametrize("shape", SHAPES)
def test_map_coordinates_equals_scipy(shape, mode):
    r = np.random.RandomState(shape[0] * 31 + shape[1])
    a = r.standard_normal(shape)
    rows, cols = _coordinates(r, *shape)
    want = sn.map_coordinates(a, [rows, cols], order=1, mode=mode)
    got = tn.map_coordinates(a, [rows, cols], order=1, mode=mode)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (np.signbit(got) == np.signbit(want)).all()


def test_legacy_wrap_period_is_n_minus_one():
    """scipy's "wrap" on arange(5.): the probe values, which a wrap of
    period n would get wrong on [n - 1, n)."""
    a = np.arange(5.0)[None].repeat(2, 0)
    x = np.array([-1.0, -0.5, 4.5, 5.0, 6.0])
    for mode, want in (("wrap", [3, 3.5, 0.5, 1, 2]),
                       ("reflect", [0, 0, 4, 4, 3])):
        got = tn.map_coordinates(a, [np.zeros(5), x], order=1, mode=mode)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [4, 7.3, 12, 0.7, 2.5,
                                   np.float64(5.123456789)])
def test_gaussian_filter_equals_scipy(sigma):
    r = np.random.RandomState(int(sigma * 10))
    for shape in ((64, 64), (70, 97), (256, 256)):
        a = r.standard_normal(shape)
        np.testing.assert_array_equal(tn.gaussian_filter(a, sigma),
                                      sn.gaussian_filter(a, sigma))
    # synth's hdrclip input: soft-edged windows in [0, 1]
    a = np.clip(r.uniform(-1, 2, (64, 64)), 0, 1)
    np.testing.assert_array_equal(tn.gaussian_filter(a, sigma),
                                  sn.gaussian_filter(a, sigma))


def test_other_arguments_raise():
    a = np.zeros((8, 8))
    c = [np.zeros((2, 2))] * 2
    for kw in ({"order": 3}, {"mode": "nearest"}, {"mode": "grid-wrap"}):
        with pytest.raises(ValueError, match="order=1"):
            tn.map_coordinates(a, c, **{"order": 1, **kw})
    with pytest.raises(ValueError, match="2-D float64"):
        tn.map_coordinates(a.astype(np.float32), c)
    with pytest.raises(ValueError, match="2-D float64"):
        tn.map_coordinates(np.zeros((2, 2, 2)), c)
    with pytest.raises(ValueError, match="differ in shape"):
        tn.map_coordinates(a, [np.zeros(3), np.zeros(4)])
    for args, kw in (((a, 0.0), {}), ((a, (1.0, 2.0)), {}),
                     ((a, 2.0), {"mode": "wrap"}),
                     ((a, 2.0), {"truncate": 3.0}),
                     ((np.zeros((4, 4, 4)), 2.0), {})):
        with pytest.raises(ValueError, match="gaussian_filter supports"):
            tn.gaussian_filter(*args, **kw)
