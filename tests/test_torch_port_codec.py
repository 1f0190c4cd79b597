"""TorchBitcoding (format v8) on a tiny model, on the CPU.

- bit-exact round trips at fbatch 1 and 8 with odd image sizes (padding),
  batch files decoding alone;
- corrupt files raise DecodeError;
- files are byte-compatible with the JAX package: for the same tiny params
  the port writes the same bytes, and each package decodes the other's
  file. On these inputs the two canaries agree (the float pack stage
  rounds the same way on the CPU), so cross-decoding is accepted, not
  refused; had they differed, the decoder would have raised DecodeError
  (canary) before emitting any pixel.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.codec.bitcoding2 import TpuBitcoding
from l3c_tpu.config import DecConfig, EncConfig, MsConfig, ProbConfig, \
    QConfig
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_torch import config as tcfg
from l3c_torch.codec.bitcoding2 import DecodeError, TorchBitcoding
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def codecs():
    jc = MsConfig(num_scales=3, Cf=8, enc=EncConfig(num_blocks=1),
                  dec=DecConfig(num_blocks=1), q=QConfig(C=5, L=25),
                  prob=ProbConfig(K=2))
    tc = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                       dec=tcfg.DecConfig(num_blocks=1),
                       q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=2))
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (TorchBitcoding(tc, tn, device="cpu"),
            lambda: TpuBitcoding(jc, jn, params))


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (1, h, w, 3)) \
        .astype(np.uint8)


def test_roundtrip_fbatch1_padded(codecs, tmp_path):
    bc, _ = codecs
    img = _img(19, 45, 1)
    p = str(tmp_path / "a.l3c")
    bpsp = bc.encode(img, p)
    assert 0 < bpsp < 35
    np.testing.assert_array_equal(bc.decode(p), img)


def test_roundtrip_fbatch8_batch(codecs, tmp_path):
    bc, _ = codecs
    imgs = [_img(21, 13, 10 + i) for i in range(6)]
    paths = [str(tmp_path / f"b{i}.l3c") for i in range(6)]
    bc.encode_batch(imgs, paths)
    assert open(paths[0], "rb").read()[6] == 8          # fbatch byte
    for im, o in zip(imgs, bc.decode_batch(paths)):
        np.testing.assert_array_equal(o, im)
    # a file of the batch decodes alone (the fbatch contract)
    np.testing.assert_array_equal(bc.decode(paths[3]), imgs[3])
    with pytest.raises(DecodeError, match="fbatch"):
        single = str(tmp_path / "s.l3c")
        bc.encode(imgs[0], single)
        bc.decode_batch([single, paths[0]])


def test_float_rows_on_decode(codecs, tmp_path):
    """decode_batch(float_rows=True) builds the scale-0 v7 float rows of
    every channel (strictly increasing, column 0 pinned to 0)."""
    bc, _ = codecs
    img = _img(16, 16, 5)
    p = str(tmp_path / "f.l3c")
    bc.encode(img, p)
    out = bc.decode_batch([p], float_rows=True)[0]
    np.testing.assert_array_equal(out, img)
    rows = bc.last_float_rows["rows"]
    assert len(rows) == 3
    for coarse, fine in rows:
        for r in (coarse, fine):
            assert r.shape == (256, 16) and (r[:, 0] == 0).all()
            top = torch.full((256, 1), 65536)
            assert (torch.diff(torch.cat([r, top], 1), dim=1) >= 1).all()


def test_corrupt_files_raise(codecs, tmp_path):
    bc, _ = codecs
    img = _img(16, 16, 4)
    p = str(tmp_path / "c.l3c")
    bc.encode(img, p)
    blob = bytearray(open(p, "rb").read())
    cases = {"scales": (5, 99), "fbatch": (6, 99), "canary": (8, None),
             "magic": (0, 0)}
    for name, (i, v) in cases.items():
        bad = bytearray(blob)
        bad[i] = (bad[i] ^ 0xFF) if v is None else v
        q = str(tmp_path / f"bad_{name}.l3c")
        open(q, "wb").write(bytes(bad))
        with pytest.raises(DecodeError):
            bc.decode(q)
    q = str(tmp_path / "trunc.l3c")
    open(q, "wb").write(bytes(blob[:-40]))
    with pytest.raises(DecodeError):
        bc.decode(q)


def test_autocrop_part_files(codecs, tmp_path, monkeypatch):
    """Images above the crop threshold go to .partN files and stitch back."""
    from l3c_torch.codec import part_suffix
    monkeypatch.setenv("AC_NEEDS_CROP_DIM", "24,24")
    bc, _ = codecs
    img = _img(48, 40, 31)
    p = str(tmp_path / "big.l3c")
    assert bc.encode(img, p) > 0
    parts = part_suffix.iter_part_paths(p + ".part0")
    assert len(parts) == 4
    np.testing.assert_array_equal(bc.decode(parts[0]), img)


@pytest.mark.parametrize("spread", [40, 300])
def test_unit_framing_matches_jax(spread, tmp_path):
    """Unit framing byte for byte: length-block mode 0 (base + u8 deltas)
    for a spread <= 255, mode 1 (raw u16 lengths) above."""
    import io
    from l3c_tpu.codec import bitcoding2 as jb2
    from l3c_torch.codec import bitcoding2 as tb2
    rng = np.random.RandomState(spread)
    lens = rng.randint(2, 2 + spread, 24)
    lens[0], lens[1] = 2, 1 + spread
    words = rng.randint(0, 1 << 16, (24, int(lens.max()))).astype(np.int32)
    a, b = io.BytesIO(), io.BytesIO()
    tb2._write_unit(a, words, lens, 1024)
    jb2._write_unit(b, words.astype(np.uint16), lens, 1024)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue()[6] == (0 if spread <= 255 else 1)
    T, payload, got = tb2._read_unit(io.BytesIO(a.getvalue()))
    assert T == 1024
    np.testing.assert_array_equal(got, lens)
    np.testing.assert_array_equal(
        payload, words[np.arange(words.shape[1])[None] < lens[:, None]])


def test_cross_decode_with_jax(codecs, tmp_path):
    bc, make_jax = codecs
    jb = make_jax()
    img = _img(19, 21, 7)
    pt, pj = str(tmp_path / "port.l3c"), str(tmp_path / "jax.l3c")
    bc.encode(img, pt)
    jb.encode(img, pj)
    same_canary = bc.canary(4) == jb._canary()
    print(f"canary port {bc.canary(4):#010x} jax {jb._canary():#010x}: "
          f"{'cross-decode accepted' if same_canary else 'refused'}")
    if not same_canary:
        with pytest.raises(DecodeError, match="canary"):
            bc.decode(pj)
        return
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(bc.decode(pj), img)
    np.testing.assert_array_equal(jb.decode(pt), img)
