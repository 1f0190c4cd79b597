"""The port's AV1 decoder parts (l3c_torch/data/av1_*.py) on their own:
the tables against the bundled libavif (which links dav1d and aom's
common code), the range decoder against a test-only range encoder (aom's
od_ec encoder with the whole low word kept), the inverse transforms
against their real-valued definitions, the lossless WHT round trip, and
the frame-header refusals on AV1 headers written here.

`python tests/test_torch_port_av1.py` rewrites l3c_torch/data/av1_tables.py
from the library: each table is found by its leading values and read in
the layout its owner keeps (aom's CDFs as 32768 - cdf with the closing 0
and a counter, padded to the array's largest alphabet; dav1d's as its
inverse CDF and counter; the others as their C arrays); and
l3c_torch/data/av1_qm.bin, libaom's dequantization matrices.
"""
from __future__ import annotations

import glob
import math
import os
import textwrap

import numpy as np
import PIL
import pytest

from l3c_torch.data import av1_obu, av1_recon, av1_tables
from l3c_torch.data.av1_symbol import SymbolReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = os.path.join(ROOT, "l3c_torch", "data", "av1_tables.py")
QM = os.path.join(ROOT, "l3c_torch", "data", "av1_qm.bin")


def libavif():
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libavif*"))
    return libs[0] if libs else None


# ------------------------------------------------------------ the tables

# name -> (owner, slot, alphabet(s)): the CDF arrays in the library
# (owner "aom": slot = the padded size of one CDF in u16; "dav1d": the
# alphabet's inverse CDF with the counter in its last place)
_CDF_LAYOUT = {
    "KF_Y_MODE": ("aom", 14, 13), "ANGLE_DELTA": ("aom", 8, 7),
    "UV_MODE_CFL_NOT_ALLOWED": ("aom", 15, 13),
    "UV_MODE_CFL_ALLOWED": ("aom", 15, 14),
    "PARTITION": ("aom", 11, (4,) * 4 + (10,) * 12 + (8,) * 4),
    "INTRA_TX_SET1": ("aom", 17, 7), "INTRA_TX_SET2": ("aom", 17, 5),
    "CFL_ALPHA": ("aom", 17, 16),
    "TX_DEPTH": ("aom", 4, (2,) * 3 + (3,) * 9),
    "DELTA_LF_MULTI": ("aom", 5, 4), "FILTER_INTRA": ("aom", 3, 2),
    "PALETTE_Y_SIZE": ("aom", 8, 7), "PALETTE_UV_SIZE": ("aom", 8, 7),
    "PALETTE_Y_COLOR": ("aom", 9, tuple(i // 5 + 2 for i in range(35))),
    "PALETTE_UV_COLOR": ("aom", 9, tuple(i // 5 + 2 for i in range(35))),
    "PALETTE_Y_MODE": ("aom", 3, 2),
    "EOB_PT_16": ("aom", 6, 5), "EOB_PT_32": ("aom", 7, 6),
    "EOB_PT_64": ("aom", 8, 7), "EOB_PT_128": ("aom", 9, 8),
    "EOB_PT_256": ("aom", 10, 9), "EOB_PT_512": ("aom", 11, 10),
    "EOB_PT_1024": ("aom", 12, 11), "COEFF_BASE_EOB": ("aom", 4, 3),
    "COEFF_BASE": ("aom", 5, 4), "COEFF_BR": ("aom", 5, 4),
    "DC_SIGN": ("aom", 3, 2), "EOB_EXTRA": ("aom", 3, 2),
    "TXB_SKIP": ("aom", 3, 2),
    "CFL_SIGN": ("dav1d", 8, 8), "FILTER_INTRA_MODE": ("dav1d", 8, 5),
    "SEGMENT_ID": ("dav1d", 8, 8), "SKIP": ("dav1d", 2, 2),
    "PALETTE_UV_MODE": ("dav1d", 2, 2),
    "DELTA_Q": ("aom", 5, 4), "DELTA_LF": ("aom", 5, 4),
    "RESTORE_SWITCHABLE": ("dav1d", 4, 3), "RESTORE_WIENER": ("dav1d", 2, 2),
    "RESTORE_SGRPROJ": ("dav1d", 2, 2),
    "INTRABC": ("aom", 3, 2), "TXFM_SPLIT": ("aom", 3, 2),
    "INTER_TX_SET1": ("aom", 17, 16), "INTER_TX_SET2": ("aom", 17, 12),
    "INTER_TX_SET3": ("aom", 17, 2), "MV_JOINT": ("aom", 5, 4),
    "MV_CLASS": ("aom", 12, 11), "MV_CLASS0": ("aom", 3, 2),
    "MV_SIGN": ("aom", 3, 2), "MV_BITS": ("aom", 3, 2),
    # inter frames
    "Y_MODE": ("aom", 14, 13), "SWITCHABLE_INTERP": ("aom", 4, 3),
    "INTERINTRA_MODE": ("aom", 5, 4), "WEDGE_INTERINTRA": ("aom", 3, 2),
    "WEDGE_IDX": ("aom", 17, 16), "COMPOUND_TYPE": ("aom", 3, 2),
    "COMPOUND_MODE": ("aom", 9, 8), "OBMC": ("aom", 3, 2),
    "MOTION_MODE": ("aom", 4, 3), "REF_MV": ("aom", 3, 2),
    "NEW_MV": ("aom", 3, 2), "COMP_GROUP_IDX": ("aom", 3, 2),
    "COMPOUND_IDX": ("aom", 3, 2), "SINGLE_REF": ("aom", 3, 2),
    "COMP_BWD_REF": ("aom", 3, 2), "COMP_REF": ("aom", 3, 2),
    "UNI_COMP_REF": ("aom", 3, 2), "MV_CLASS0_FR": ("aom", 5, 4),
    "MV_FR": ("aom", 5, 4), "MV_CLASS0_HP": ("aom", 3, 2),
    "MV_HP": ("aom", 3, 2), "SKIP_MODE": ("dav1d", 2, 2),
    "ZERO_MV": ("dav1d", 2, 2), "DRL": ("dav1d", 2, 2),
    "IS_INTER": ("dav1d", 2, 2), "COMP_MODE": ("dav1d", 2, 2),
    "COMP_REF_TYPE": ("dav1d", 2, 2), "INTERINTRA": ("dav1d", 2, 2),
    "SEGMENT_PRED": ("dav1d", 2, 2),
}
INTER_CDFS = tuple(list(_CDF_LAYOUT)[list(_CDF_LAYOUT).index("Y_MODE"):])
# the other tables: (numpy type, count)
_PLAIN = {"DC_QLOOKUP": ("<i2", 256), "AC_QLOOKUP": ("<i2", 256),
          "DR_INTRA_DERIVATIVE": ("<i2", 90), "SM_WEIGHTS": ("u1", 124),
          "FILTER_INTRA_TAPS": ("i1", 320), "COS128": ("<i4", 64),
          "SINPI": ("<i4", 5), "SGR_PARAMS": ("<i4", 64),
          "X_BY_XPLUS1": ("<i4", 256), "ONE_BY_X": ("<i4", 25),
          "CDEF_UV_DIR": ("u1", 16), "CDEF_DIRECTIONS": ("i1", 24),
          "CDEF_PRI_TAPS": ("<i4", 4), "CDEF_DIV_TABLE": ("<i4", 9),
          "WIENER_TAPS_MID": ("<i4", 3),
          "GAUSSIAN_SEQUENCE": ("<i2", 2048), "RESIZE_FILTER": ("i1", 512),
          # inter prediction: dav1d's subpel filters (halved taps, phases
          # 1-15 of regular, smooth, sharp, 4-tap regular, 4-tap smooth,
          # bilinear), its warp filter and OBMC masks (the neighbour's
          # weight); aom's division LUT, wedge master lines (oblique odd,
          # oblique even) and codebooks (h < w, h > w, h == w), inter-intra
          # weights, distance weights and lookup, and MV projection
          # multipliers
          "MC_SUBPEL_FILTERS": ("i1", 720), "MC_WARP_FILTER": ("i1", 1544),
          "OBMC_MASKS": ("u1", 64), "DIV_LUT": ("<u2", 257),
          "WEDGE_MASTER": ("u1", 128), "WEDGE_MASTER_VERTICAL": ("u1", 64),
          "WEDGE_CODEBOOK": ("<i4", 144), "II_WEIGHTS_1D": ("u1", 128),
          "QUANT_DIST": ("<i4", 16), "DIV_MULT": ("<i4", 32)}
INTER_PLAIN = tuple(list(_PLAIN)[list(_PLAIN).index("MC_SUBPEL_FILTERS"):])
# constants neither library keeps as an array (macros, inline code): the
# specification's values, kept by the rewrite
_SPEC = {"WIENER_TAPS_MIN": (-5, -23, -17), "WIENER_TAPS_MAX": (10, 8, 46),
         "WIENER_TAPS_K": (1, 2, 3), "SGRPROJ_XQD_MIN": (-96, -32),
         "SGRPROJ_XQD_MAX": (31, 95), "SGRPROJ_XQD_MID": (-32, 31),
         "CDEF_SEC_TAPS": (2, 1, 2, 1)}


def _count(shape):
    return int(np.prod(shape)) if shape else 1


def _find(lib, pat):
    at = lib.find(pat)
    assert at >= 0, "a table's leading values are not in the library"
    return at


def _read_cdfs(lib, name, shape, anchor):
    owner, slot, ns = _CDF_LAYOUT[name]
    n = _count(shape)
    ns = (ns,) * n if isinstance(ns, int) else ns
    pat, at = [], 0
    # the first three CDFs, padded (an inter table whole: many of them
    # lead with the same uniform CDFs)
    for k in ns if name in INTER_CDFS else ns[:3]:
        c = list(anchor[at:at + k])
        at += k
        c = c[:-1] + ([0, 0] if owner == "aom" else [0])
        pat += c + [0] * (slot - len(c))
    at = _find(lib, np.array(pat, "<u2").tobytes())
    out = []
    for i, k in enumerate(ns):
        cdf = np.frombuffer(lib, "<u2", k, at + 2 * slot * i).tolist()
        cdf[-1] = 0                    # dav1d's counter -> the closing 0
        out.append(tuple(cdf))
    return out


# dav1d's dq_tbl: (DC, AC) pairs by depth 8, 10, 12, the 8-bit pairs
# found by the committed 8-bit lookups
DEEP_Q = ("DC_QLOOKUP_10", "AC_QLOOKUP_10", "DC_QLOOKUP_12", "AC_QLOOKUP_12")


def deep_qlookups(lib: bytes) -> dict:
    """The 10- and 12-bit DC / AC lookups: dav1d's pairs table after its
    8-bit pairs."""
    pairs = np.stack([av1_tables.DC_QLOOKUP, av1_tables.AC_QLOOKUP],
                     1).astype("<u2")
    at = _find(lib, pairs.tobytes())
    tbl = np.frombuffer(lib, "<u2", 3 * 512, at).reshape(3, 256, 2)
    return {name: tuple(int(v) for v in tbl[1 + k // 2, :, k % 2])
            for k, name in enumerate(DEEP_Q)}


def tables_from(lib: bytes) -> dict:
    """Every table re-read from the library, the committed one's leading
    values leading the way."""
    got = {"CDFS": {}}
    for name, (shape, ns, flat) in av1_tables.CDFS.items():
        cdfs = _read_cdfs(lib, name, shape, flat)
        got["CDFS"][name] = (shape, ns, tuple(v for c in cdfs for v in c))
    for name, (dt, n) in _PLAIN.items():
        want = np.array(getattr(av1_tables, name)[:n], dt)
        # the inter tables are found by their leading non-zero values
        lead = int(np.flatnonzero(want)[0]) if name in INTER_PLAIN else 0
        at = _find(lib, want[lead:lead + 12].tobytes()) - \
            lead * want.itemsize
        got[name] = tuple(int(v) for v in np.frombuffer(lib, dt, n, at))
    got["COS128"] += (0,)               # cos(pi / 2), the table's 65th entry
    got.update(deep_qlookups(lib))
    return got


def test_tables_are_the_bundled_librarys():
    """Each committed table is the library's bytes: found by its leading
    values and read whole in its owner's layout."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    with open(path, "rb") as f:
        lib = f.read()
    got = tables_from(lib)
    assert got["CDFS"] == av1_tables.CDFS
    for name in _PLAIN:
        assert got[name] == tuple(getattr(av1_tables, name)), name


def test_cdf_tables_are_well_formed():
    """Inverse CDFs: strictly decreasing, ending in 0, of the alphabet
    their syntax element has; the coefficient CDFs in four q contexts."""
    for name, (shape, ns, flat) in av1_tables.CDFS.items():
        ns = (ns,) * _count(shape) if isinstance(ns, int) else ns
        assert sum(ns) == len(flat), name
        at = 0
        for k in ns:
            c = flat[at:at + k]
            assert c[-1] == 0 and all(a > b for a, b in zip(c, c[1:])), name
            assert c[0] < 32768, name
            at += k
        if name.startswith(("COEFF", "EOB", "DC_SIGN", "TXB")):
            assert shape[0] == 4, name


# ------------------------------------------------------ the range decoder

class RangeEncoder:
    """aom's od_ec encoder (od_ec_encode_q15), its low word kept whole:
    the stream is `low` itself, zero-padded, which lies in the final
    interval."""

    def __init__(self):
        self.low, self.rng, self.bits = 0, 0x8000, 15

    def symbol(self, s, icdf):
        n = len(icdf) - 1
        r = self.rng
        v = ((r >> 8) * (icdf[s] >> 6) >> 1) + 4 * (n - s)
        if s > 0:
            u = ((r >> 8) * (icdf[s - 1] >> 6) >> 1) + 4 * (n - s + 1)
            self.low += r - u
            r = u - v
        else:
            r -= v
        d = 16 - r.bit_length()
        self.low <<= d
        self.rng = r << d
        self.bits += d

    def bool(self, b):
        self.symbol(b, [16384, 0])

    def data(self) -> bytes:
        pad = -self.bits % 8
        return (self.low << pad).to_bytes((self.bits + pad) // 8, "big")


def _adapt(cdf, s, cnt):
    """The specification's CDF update (independent of the decoder's)."""
    n = len(cdf)
    rate = 3 + (cnt > 15) + (cnt > 31) + min(int(math.log2(n)), 2)
    for i in range(n - 1):
        tmp = 32768 if i >= s else 0
        c = 32768 - cdf[i]
        c = c - ((c - tmp) >> rate) if tmp < c else c + ((tmp - c) >> rate)
        cdf[i] = 32768 - c
    return min(cnt + 1, 32)


def _random_icdf(r, n):
    cuts = np.sort(r.choice(np.arange(1, 32768), n - 1, replace=False))
    return [32768 - int(c) for c in cuts] + [0]


@pytest.mark.parametrize("disable_update", [False, True])
def test_symbol_decoder_against_a_range_encoder(disable_update):
    r = np.random.RandomState(3 + disable_update)
    cdfs = [_random_icdf(r, n) for n in range(2, 17)]
    enc_cdfs = [list(c) for c in cdfs]
    counts = [0] * len(cdfs)
    ops = []
    enc = RangeEncoder()
    for _ in range(4000):
        kind = r.randint(3)
        if kind == 0:
            k = r.randint(len(cdfs))
            c = enc_cdfs[k]
            p = np.diff([0] + [32768 - v for v in c]) / 32768.0
            s = int(r.choice(len(c), p=p / p.sum()))
            enc.symbol(s, c)
            if not disable_update:
                counts[k] = _adapt(c, s, counts[k])
            ops.append(("s", k, s))
        elif kind == 1:
            b = int(r.randint(2))
            enc.bool(b)
            ops.append(("b", b))
        else:
            n = int(r.randint(1, 9))
            v = int(r.randint(1 << n))
            for i in range(n - 1, -1, -1):
                enc.bool((v >> i) & 1)
            ops.append(("l", n, v))
    data = enc.data()
    rd = SymbolReader(data, 0, len(data), disable_update)
    dec_cdfs = [list(c) + [0] for c in cdfs]
    for op in ops:
        if op[0] == "s":
            assert rd.symbol(dec_cdfs[op[1]]) == op[2]
        elif op[0] == "b":
            assert rd.bool() == op[1]
        else:
            assert rd.literal(op[1]) == op[2]
    if not disable_update:
        assert [c[:-1] for c in dec_cdfs] == enc_cdfs
    else:
        assert [c[:-1] for c in dec_cdfs] == cdfs


def test_symbol_decoder_reads_zeros_past_the_end():
    """Past its bytes a tile reads as zero data (the specification's
    padding), which the inverted value holds as ones: every bool is 0."""
    rd = SymbolReader(b"", 0, 0, True)
    assert [rd.bool() for _ in range(40)] == [0] * 40


# ---------------------------------------------------- inverse transforms

def _dct_ref(x):
    n = len(x)
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[:, 0] = 1 / math.sqrt(2)
    return m @ np.asarray(x, float)


def _adst_ref(x):
    n = len(x)
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if n == 4:
        m = np.sin(np.pi * (i + 1) * (2 * k + 1) / 9) * 2 * math.sqrt(2) / 3
    else:
        m = np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * n))
    return m @ np.asarray(x, float)


def _run(fn, x):
    return np.array([int(v[0]) for v in fn([np.array([v]) for v in x])])


def _tol(n, x):
    """A rounding to an integer at each of log2(n) stages, and cosines
    held to 12 bits (an error of at most 2^-13 a product)."""
    return math.log2(n) + np.abs(x).sum() * 2.0 ** -12


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_idct_equals_its_definition_within_its_rounding(n):
    """Each rotation rounds once (12-bit cosines): the result stays
    within its rounding of the real DCT over 50 random inputs."""
    r = np.random.RandomState(n)
    for _ in range(50):
        x = r.randint(-4000, 4001, n)
        assert np.abs(_run(av1_recon.idct, x) - _dct_ref(x)).max() <= \
            _tol(n, x)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_iadst_equals_its_definition_within_its_rounding(n):
    r = np.random.RandomState(100 + n)
    for _ in range(50):
        x = r.randint(-4000, 4001, n)
        assert np.abs(_run(av1_recon.iadst, x) - _adst_ref(x)).max() <= \
            _tol(n, x)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_identity_scales_by_its_factor(n):
    x = np.random.RandomState(200 + n).randint(-4000, 4001, n)
    got = _run(av1_recon.iidentity, x)
    scale = {4: 5793 / 4096, 8: 2, 16: 11586 / 4096, 32: 4}[n]
    assert np.abs(got - scale * x).max() <= 0.5           # sqrt 2 in 12 bits
    exact = {4: math.sqrt(2), 8: 2, 16: 2 * math.sqrt(2), 32: 4}[n]
    assert abs(scale / exact - 1) < 2 ** -12


def _fwht_1d(o):
    """The forward step that undoes one inverse WHT step exactly."""
    a_out, b_out, c_out, d_out = o
    d2 = d_out - c_out
    a2 = a_out + b_out
    e = (a2 - d2) >> 1
    c0, b0 = e - c_out, e - b_out
    return [a2 - c0, c0, d2 + b0, b0]       # positions 0..3: a, c, d, b


def test_wht_round_trips_bit_exactly():
    """Lossless: coefficients found by undoing the inverse columns, then
    rows, come back to every residual exactly."""
    r = np.random.RandomState(7)
    for _ in range(300):
        res = r.randint(-255, 256, (4, 4))
        cols = np.array([_fwht_1d(list(res[:, j])) for j in range(4)]).T
        coef = np.array([_fwht_1d(list(cols[i])) for i in range(4)])
        got = av1_recon.inverse_wht([int(4 * v) for v in coef.ravel()])
        assert np.array_equal(np.array(got), res)


@pytest.mark.parametrize("kind, n", [("dct", 4), ("dct", 8), ("dct", 16),
                                     ("dct", 32), ("dct", 64), ("adst", 8),
                                     ("adst", 16)])
def test_transform_sums_weigh_inputs_by_at_most_one(kind, n):
    """Every sum and difference of the DCT / ADST networks (where dav1d
    clips to 16 bits) weighs each input by at most 1: driven by one input
    at 2^24 at a time, none exceeds it. So a pass whose inputs' absolute
    sum is below 2^15 - MARGIN cannot reach the clip, and
    `inverse_transform` skips it there."""
    seen = []

    def record(v):
        seen.append(int(np.abs(v).max()))
        return v
    fn = av1_recon.idct if kind == "dct" else av1_recon.iadst
    scale = 1 << 24
    for j in range(n):
        for sign in (1, -1):
            seen.clear()
            fn([np.array([sign * scale * (i == j)], np.int64)
                for i in range(n)], record)
            assert seen and max(seen) <= scale, (j, sign)


def test_clipped_and_unclipped_passes_agree_below_the_margin():
    """Seeded blocks whose rows sum below the margin: the clipped and the
    unclipped networks give the same values; above it the clips act."""
    r = np.random.RandomState(12)
    lim = av1_recon.HI - av1_recon.MARGIN
    for n, fn in ((8, av1_recon.idct), (32, av1_recon.idct),
                  (16, av1_recon.iadst)):
        x = r.randint(-4000, 4001, (50, n))
        x = x * (lim // np.abs(x).sum(1, keepdims=True).clip(1)) // 2
        vec = [x[:, j] for j in range(n)]
        a = fn(vec, av1_recon._clip)
        b = fn(vec, av1_recon._keep)
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
        big = [np.full(50, 30000 - 100 * j, np.int64) for j in range(n)]
        assert any(not np.array_equal(u, v) for u, v in zip(
            fn(big, av1_recon._clip), fn(big, av1_recon._keep)))


def test_flipped_adst_is_the_adst_reversed():
    r = np.random.RandomState(9)
    c = np.zeros((8, 8), np.int64)
    c[:4, :4] = r.randint(-300, 301, (4, 4))
    tx = 1                                            # TX_8X8
    a = av1_recon.inverse_transform(c, 3, tx, 8, 8)   # ADST_ADST
    assert np.array_equal(av1_recon.inverse_transform(c, 6, tx, 8, 8),
                          a[::-1, ::-1])              # FLIPADST_FLIPADST
    assert np.array_equal(av1_recon.inverse_transform(c, 7, tx, 8, 8),
                          a[:, ::-1])                 # ADST_FLIPADST


# -------------------------------------------------------- header refusals

class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def data(self, trailing=True):
        b = self.bits + ([1] if trailing else [])
        b += [0] * (-len(b) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


def _obu(typ, payload):
    return bytes([(typ << 3) | 2, len(payload)]) + payload


def av1_still(w=16, h=16, high=0, cdef=(0, 0), lr=0, superres=0, grain=0,
              qmatrix=0, lf=(0, 0), screen=0, intrabc=0, base_q=40,
              delta_lf=0):
    """A reduced-still-picture sequence header and a frame OBU whose
    header carries the given tools (one tile of zero data)."""
    s = BitWriter().f(3, 0).f(1, 1).f(1, 1).f(5, 0)   # profile 0, still
    s.f(4, 15).f(4, 15).f(16, w - 1).f(16, h - 1)
    s.f(1, 0).f(1, 1).f(1, 1)                   # sb64, filter intra, edge
    s.f(1, superres).f(1, int(any(cdef))).f(1, lr)
    s.f(1, high).f(1, 0).f(1, 0).f(1, 1)        # 8/10 bit, colour, range
    s.f(2, 0).f(1, 0).f(1, grain)               # csp, separate uv, grain
    fh = BitWriter().f(1, 0).f(1, screen)       # cdf update, screen tools
    if screen:
        fh.f(1, 0)                              # force_integer_mv
    if superres:
        fh.f(1, 1).f(3, 0)
    fh.f(1, 0)                                  # render size
    if screen:
        fh.f(1, intrabc)
    fh.f(1, 1)                                  # uniform tiles
    fh.f(8, base_q).f(1, 0).f(1, 0).f(1, 0)     # base q, dc/uv deltas
    fh.f(1, qmatrix)
    if qmatrix:
        fh.f(4, 0).f(4, 0)
    fh.f(1, 0).f(1, int(delta_lf))              # segmentation, delta q
    if delta_lf:
        fh.f(2, 0).f(1, 1).f(2, 0).f(1, 0)      # res, delta lf, res, multi
    fh.f(6, lf[0]).f(6, lf[1])
    if any(lf):
        fh.f(6, 0).f(6, 0)
    fh.f(3, 0).f(1, 0)                          # sharpness, lf deltas
    if any(cdef):
        fh.f(2, 0).f(2, 0).f(4, cdef[0]).f(2, 0).f(4, cdef[1]).f(2, 0)
    if lr:
        fh.f(2, 1).f(2, 0).f(2, 0).f(1, 0)      # Y switchable, 64 units
    fh.f(1, 0).f(1, 0)                          # tx mode, reduced tx set
    if grain:
        fh.f(1, 1).f(16, 0)
    return _obu(1, s.data()) + _obu(6, fh.data(trailing=False) + bytes(8))


def test_written_header_parses():
    seq, f, tiles = av1_obu.parse_av1(av1_still(24, 40), "x")
    assert (f.width, f.height, f.base_q_idx, seq.bit_depth) == (24, 40, 40,
                                                                8)
    assert len(tiles) == 1 and tiles[0][3] - tiles[0][2] == 8
    seq, _, _ = av1_obu.parse_av1(av1_still(high=1), "x")
    assert seq.bit_depth == 10


# the in-loop filters, refused until the port decoded them: their headers
# now parse, each keeping what it sets
FILTERS_NOW = {
    "the deblocking loop filter": lambda f: f.lf_level == [3, 0, 0, 0],
    "CDEF": lambda f: (f.cdef_bits, f.cdef_y, f.cdef_uv) == (0, [(2, 0)],
                                                            [(1, 0)]),
    "loop restoration": lambda f: (f.lr_type, f.lr_unit_size) == (
        [av1_obu.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64])}


# and the tools decoded since: film grain (its parameters), quantizer
# matrices (the levels), intra block copy (which turns the filters off),
# superres (16 wide at denominator 9: dav1d's floor keeps FrameWidth at
# min(16, UpscaledWidth))
TOOLS_NOW = {
    "superres": lambda f: (f.use_superres, f.superres_denom, f.width,
                           f.upscaled_width, f.mi_cols) == (1, 9, 16, 16, 4),
    "film grain": lambda f: (f.grain.seed, f.grain.y_points,
                             f.grain.cb_points, f.grain.overlap) == (
                                 0, [], [], 0),
    "quantizer matrices": lambda f: (f.using_qmatrix, f.qm_y, f.qm_u,
                                     f.qm_v) == (1, 0, 0, 0),
    "intra block copy": lambda f: f.allow_intrabc == 1 and
    f.lf_level == [0, 0, 0, 0] and f.lr_type == [0, 0, 0]}


@pytest.mark.parametrize("kw, what, tool", [
    (dict(lf=(3, 0)), "the deblocking loop filter", "levels 3, 0"),
    (dict(cdef=(2, 1)), "CDEF", "dav1d's CDEF filter"),
    (dict(lr=1), "loop restoration", "Wiener / self-guided"),
    (dict(superres=1), "superres", "super-resolution"),
    (dict(grain=1), "film grain", "film grain synthesis"),
    (dict(qmatrix=1), "quantizer matrices", "using_qmatrix"),
    (dict(screen=1, intrabc=1), "intra block copy", "intrabc")])
def test_tools_not_decoded_yet_are_refused_by_name(kw, what, tool):
    """The filters and the tools decoded since (superres the last) parse,
    each keeping what it sets; none is refused by name now."""
    now = dict(FILTERS_NOW, **TOOLS_NOW)
    if what in now:
        _, f, _ = av1_obu.parse_av1(av1_still(**kw), "x")
        assert now[what](f)
        return
    with pytest.raises(ValueError) as e:
        av1_obu.parse_av1(av1_still(**kw), "x")
    assert f"AVIF with {what} is not decoded by the port yet" in \
        str(e.value)
    assert tool in str(e.value)


@pytest.mark.parametrize("lf, refused", [((3, 0), True), ((0, 5), True),
                                         ((0, 0), False)])
def test_delta_lf_with_deblocking_is_refused_by_name(lf, refused):
    """Per-block loop filter deltas steer the deblocking levels: once
    refused by name with a level on, they now parse with the levels on or
    off, keeping their resolution and multi flag (their pixels:
    tests/test_torch_port_avif_tools.py)."""
    _, f, _ = av1_obu.parse_av1(av1_still(lf=lf, delta_lf=1), "x")
    assert (f.delta_lf_present, f.delta_lf_res, f.delta_lf_multi) == (1, 0, 0)
    assert f.lf_level[:2] == list(lf) and bool(any(lf)) == refused


def test_loop_filter_deltas_and_sharpness_parse():
    """A loop filter delta update and sharpness (written here) are kept:
    setup_past_independence's ref deltas where no update is sent."""
    _, f, _ = av1_obu.parse_av1(av1_still(lf=(9, 4)), "x")
    assert f.lf_ref_deltas == [1, 0, 0, 0, -1, 0, -1, -1]
    assert f.lf_mode_deltas == [0, 0] and f.lf_delta_enabled == 0


def test_spec_constants_of_the_filters():
    """The in-loop filters' tables against the specification's printed
    values: the default restoration CDFs (9413, 22581; 11570; 16855),
    Sgr_Params, Cdef_Directions, Cdef_Uv_Dir, the CDEF taps and divisors,
    the Wiener and self-guided coefficient bounds."""
    T = av1_tables
    spec_cdf = {"RESTORE_SWITCHABLE": (9413, 22581), "RESTORE_WIENER":
                (11570,), "RESTORE_SGRPROJ": (16855,)}
    for name, cdf in spec_cdf.items():
        assert T.CDFS[name][2] == tuple(32768 - v for v in cdf) + (0,)
    spec_sgr = ((2, 140, 1, 3236), (2, 112, 1, 2158), (2, 93, 1, 1618),
                (2, 80, 1, 1438), (2, 70, 1, 1295), (2, 58, 1, 1177),
                (2, 47, 1, 1079), (2, 37, 1, 996), (2, 30, 1, 925),
                (2, 25, 1, 863), (0, -1, 1, 2589), (0, -1, 1, 1618),
                (0, -1, 1, 1177), (0, -1, 1, 925), (2, 56, 0, -1),
                (2, 22, 0, -1))
    for k, (r0, s0, r1, s1) in enumerate(spec_sgr):
        assert T.SGR_PARAMS[4 * k:4 * k + 4] == (r0, r1, s0, s1)
    from l3c_torch.data import av1_cdef
    assert av1_cdef.DIRS == (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)),
                             ((0, 1), (0, 2)), ((0, 1), (1, 2)),
                             ((1, 1), (2, 2)), ((1, 0), (2, 1)),
                             ((1, 0), (2, 0)), ((1, 0), (2, -1)))
    assert T.CDEF_UV_DIR == tuple(range(8)) + (7, 0, 2, 4, 5, 6, 6, 6)
    assert T.CDEF_PRI_TAPS == (4, 2, 3, 3) and T.CDEF_SEC_TAPS == (2, 1,
                                                                   2, 1)
    assert T.CDEF_DIV_TABLE == (0, 840, 420, 280, 210, 168, 140, 120, 105)
    assert (T.WIENER_TAPS_MIN, T.WIENER_TAPS_MID, T.WIENER_TAPS_MAX,
            T.WIENER_TAPS_K) == ((-5, -23, -17), (3, -7, 15), (10, 8, 46),
                                 (1, 2, 3))
    assert (T.SGRPROJ_XQD_MIN, T.SGRPROJ_XQD_MID, T.SGRPROJ_XQD_MAX) == (
        (-96, -32), (-32, 31), (31, 95))
    # x / (x + 1) in 8 bits and 1 / x in 12, as the spec computes them
    assert T.X_BY_XPLUS1 == (1,) + tuple(((z << 8) + z // 2) // (z + 1)
                                         for z in range(1, 255)) + (256,)
    assert T.ONE_BY_X == tuple((4096 + n // 2) // n for n in range(1, 26))


def test_film_grain_points_dav1d_refuses_are_damaged():
    """dav1d refuses film grain points whose values do not increase, more
    than 14 luma points, and grain on one 4:2:0 chroma plane only."""
    def still(fg_bits):
        blob = bytearray(av1_still(grain=1))
        head = blob.rfind(bytes([(6 << 3) | 2]))    # the frame OBU
        at, end = head + 2, head + 2 + blob[head + 1]
        _, f, _ = av1_obu.parse_av1(bytes(blob), "x")
        bits = "".join(f"{v:08b}" for v in blob[at:end])
        cut = _grain_at(bytes(blob))
        bits = bits[:cut] + fg_bits + bits[cut + len(fg_bits):]
        blob[at:end] = int(bits, 2).to_bytes(end - at, "big")
        return bytes(blob)
    seed = "0" * 16
    pts = lambda vals: f"{len(vals):04b}" + "".join(  # noqa: E731
        f"{v:08b}{40:08b}" for v in vals)
    for fg, why in ((seed + pts([10, 10]), "do not increase"),
                    (seed + "1111", "15 film grain points"),
                    (seed + pts([10]) + "0" + pts([20]) + pts([]),
                     "one 4:2:0 chroma plane")):
        with pytest.raises(ValueError, match="damaged") as e:
            av1_obu.parse_av1(still(fg), "x")
        assert why in str(e.value)


def _grain_at(blob):
    """The bit (in its OBU's payload) where film_grain_params' seed starts
    in a written still with grain."""
    reads = []

    class Log(av1_obu.Bits):
        def f(self, n):
            reads.append((self.bit, n))
            return super().f(n)
    obus = list(av1_obu.obus(blob, "x"))
    seq = av1_obu.sequence_header(av1_obu.Bits(blob, obus[0][3], obus[0][4],
                                               "x"))
    _, _, _, at, end = obus[1]
    av1_obu.frame_header(Log(blob, at, end, "x"), seq)
    k = [i for i, (_, n) in enumerate(reads) if n == 16][-1]
    return reads[k][0] - 8 * at


def test_gaussian_sequence_and_quantizer_matrices():
    """The two large tables the new tools read: film grain's 2048-entry
    Gaussian sequence (in av1_tables) and the 15 levels x 2 plane types x
    3344 dequantization weights (av1_qm.bin, libaom's iqm_tbl layout:
    the sizes to 32 x 32 in transform-size order, each by columns), by
    digest, by the specification's printed entries, and against the
    bundled library's bytes."""
    import hashlib
    from l3c_torch.data import av1_block
    g = np.array(av1_tables.GAUSSIAN_SEQUENCE, "<i2")
    assert hashlib.sha256(g.tobytes()).hexdigest() == \
        "3b46df1c6c84b2c0e374d10e3fbaf443d2b5f87a857f903d16486defc52525a9"
    assert g[:13].tolist() == [56, 568, -180, 172, 124, -84, 172, -64,
                               -900, 24, 820, 224, 1248]
    assert g[-3:].tolist() == [944, 428, -484]
    with open(QM, "rb") as f:
        qm = f.read()
    assert len(qm) == 15 * 2 * 3344
    assert hashlib.sha256(qm).hexdigest() == \
        "f1d670f202256018637ba4b9d784c70b1e4404ae69316d94963e17fbc9f5a297"
    assert av1_block.qmatrix(0, 0, 0).ravel().tolist() == [
        32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200]
    assert av1_block.qmatrix(14, 1, 0).ravel().tolist() == [31] * 16
    for lvl in range(15):
        for c in (0, 1):
            for tx, at in av1_block.QM_OFFSET.items():
                m = av1_block.qmatrix(lvl, c, tx)
                w, h = av1_block.TX_WH[tx]
                assert m.shape == (h, w) and m[0, 0] <= 32 + 4 * c
                # a square's weights are symmetric, a rectangle's are
                # its transposed partner's (w x h against h x w)
                other = av1_block.TX_BY_WH[(h, w)]
                assert np.array_equal(m, av1_block.qmatrix(lvl, c, other).T)
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    with open(path, "rb") as f:
        lib = f.read()
    assert lib.find(qm) >= 0
    assert lib.find(g.tobytes()) >= 0


def test_inter_transform_sets_are_the_librarys():
    """The inter transform sets' symbol -> type maps (intra block copy)
    are libaom's av1_ext_tx_inv rows in the bundled library, which holds
    the intra ones the decoder had beside them."""
    from l3c_torch.data import av1_block as B
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    with open(path, "rb") as f:
        lib = f.read()
    at = lib.find(np.array(B.INV_SET1 + (0,) * 9, "<i4").tobytes())
    assert at >= 0
    rows = np.frombuffer(lib, "<i4", 16 * 3, at + 64).reshape(3, 16)
    assert tuple(rows[0, :12]) == B.INTER_INV[1]
    assert tuple(rows[1]) == B.INTER_INV[0]
    first = np.frombuffer(lib, "<i4", 16 * 3, at - 3 * 64).reshape(3, 16)
    assert tuple(first[1, :2]) == B.INTER_INV[2]
    assert tuple(first[2, :5]) == B.INV_SET2


def test_damaged_headers_are_refused():
    """Cut headers and a frame before its sequence header are refused; a
    set forbidden bit is passed over, as dav1d without strict standard
    compliance (libavif's setting) passes it over, and so is an OBU of a
    reserved type."""
    good = av1_still()
    for blob, why in ((good[:5], "runs past"),
                      (good[2 + good[1]:], "before the sequence")):
        with pytest.raises(ValueError, match="damaged") as e:
            av1_obu.parse_av1(blob, "x")
        assert why in str(e.value)
    want = av1_obu.parse_av1(good, "x")
    reserved = bytes([(10 << 3) | 2, 1, 0])
    for blob in (bytes([good[0] | 0x80]) + good[1:], reserved + good):
        got = av1_obu.parse_av1(blob, "x")
        assert (vars(got[0]), vars(got[1])) == (vars(want[0]),
                                                vars(want[1]))


if __name__ == "__main__":
    with open(libavif(), "rb") as f:
        t = tables_from(f.read())
    head = av1_tables.__doc__
    out = [f'"""{head}"""\n\n', "CDFS = {\n"]
    for name, (shape, ns, flat) in t["CDFS"].items():
        body = ", ".join(map(str, flat))
        out.append(f"    {name!r}: ({shape!r}, {ns!r}, (\n" + textwrap.fill(
            body, 72, initial_indent=" " * 8, subsequent_indent=" " * 8) +
            ")),\n")
    out.append("}\n")
    for name in list(_PLAIN) + list(DEEP_Q) + list(_SPEC):
        body = ", ".join(map(str, t.get(name, _SPEC.get(name))))
        out.append(f"\n{name} = (\n" + textwrap.fill(
            body, 76, initial_indent="    ", subsequent_indent="    ") +
            ")\n")
    with open(TABLES, "w") as f:
        f.write("".join(out))
    with open(libavif(), "rb") as f:
        lib = f.read()
    first = bytes([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97,
                   110, 150, 200])            # level 0's luma 4 x 4
    at = _find(lib, first)
    with open(QM, "wb") as f:
        f.write(lib[at:at + 15 * 2 * 3344])
    print(f"wrote {TABLES} and {QM}")
