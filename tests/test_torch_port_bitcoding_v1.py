"""The port's format-v1 codec (l3c_torch/codec/bitcoding.py, rANS on the
host) and its dispatch, on the CPU, against the JAX package's Bitcoding.

- round trips bit-exact with and without padding, in float32 and with the
  conv stacks in bfloat16, and for a two-scale RGB baseline (unit 0 the
  bicubic pyramid's top at L = 256 under the uniform coder);
- auto-crop part files (the crop threshold monkeypatched, as the JAX
  package's test_codec.py does);
- a corrupt stream, a truncated file and a wrong version raise
  DecodeError; a file of another CDF evaluator variant is refused;
- make_bitcoding / file_version / open_decoder, the tester, cli.l3c and
  cli.test with --codec_backend host, and decode_file on a v8 and a v1
  file through the version dispatch;
- the cross-package measurement: the same weights (params_from_jax), the
  same images, both packages on the CPU. v1 has no canary: the backend
  evaluates the CDFs from the float parameters, so a one-ulp difference
  between XLA's and PyTorch's get_P moves quantized CDF values. Measured
  and held as measured: headers and unit 0 byte-identical, the packed
  parameters within 5e-7 of each tensor's largest magnitude, the files
  differing in the bytes printed, and neither package decoding the
  other's file to the source pixels (ROADMAP.md section 3).
"""
import dataclasses
import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.codec.bitcoding import Bitcoding as JBitcoding
from l3c_tpu.config import DecConfig, EncConfig, MsConfig, ProbConfig, \
    QConfig
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_torch import codec as tcodec
from l3c_torch import config as tcfg
from l3c_torch.cli import l3c as l3c_cli
from l3c_torch.cli import test as test_cli
from l3c_torch.codec import part_suffix
from l3c_torch.codec.bitcoding import Bitcoding, DecodeError
from l3c_torch.codec.bitcoding2 import TorchBitcoding
from l3c_torch.data.images import read_png, write_png
from l3c_torch.eval.tester import MultiscaleTester
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import packb, params_from_jax
from l3c_torch.train.saver import ckpt_name

torch.set_num_threads(1)

TINY_CF = ("num_scales = 3\nCf = 8\nenc.num_blocks = 1\ndec.num_blocks = 1\n"
           "q.C = 5\nq.L = 25\nprob.K = 2\n")
HEADER = 20          # magic, 4 bytes, pads, H, W


def _cfgs():
    j = MsConfig(num_scales=3, Cf=8, enc=EncConfig(num_blocks=1),
                 dec=DecConfig(num_blocks=1), q=QConfig(C=5, L=25),
                 prob=ProbConfig(K=2))
    t = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                      dec=tcfg.DecConfig(num_blocks=1),
                      q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=2))
    return j, t


@pytest.fixture(scope="module")
def codecs():
    jc, tc = _cfgs()
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(params), strict=True)
    return dict(bc=Bitcoding(tc, tn, device="cpu"),
                jb=JBitcoding(jc, jn, params), params=params, tc=tc, tn=tn)


def _img(h, w, seed):
    """Gradients plus noise (compressible)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 5, xx * 7, (yy + xx) * 3], -1)
    return ((base + rng.randint(0, 24, base.shape)) % 256).astype(
        np.uint8)[None]


@pytest.mark.parametrize("h,w", [(32, 32), (19, 27)])
def test_round_trip_bit_exact(codecs, tmp_path, h, w):
    bc = codecs["bc"]
    img = _img(h, w, h)
    p = str(tmp_path / "a.l3c")
    bpsp = bc.encode(img, p)
    assert 0 < bpsp < 30
    assert bpsp == os.path.getsize(p) * 8 / img.size
    head = open(p, "rb").read(8)
    assert head[:4] == b"L3TP" and tuple(head[4:]) == (2, 3, 4, 1)
    np.testing.assert_array_equal(bc.decode(p), img)
    assert bc.unit_scale_map() == ["uniform", "scale_2", "scale_1",
                                   "scale_0"]
    assert sum(bc.last_unit_bytes[0]) + HEADER + 4 * 4 == \
        os.path.getsize(p)                      # + four separators
    with pytest.raises(FileExistsError):
        bc.encode(img, p)


def test_bfloat16_round_trip(codecs, tmp_path):
    tc = dataclasses.replace(codecs["tc"], compute_dtype="bfloat16")
    tn = TNet(tc)
    tn.load_state_dict(codecs["tn"].state_dict())
    bc = Bitcoding(tc, tn, device="cpu")
    img = _img(24, 16, 3)
    p = str(tmp_path / "bf.l3c")
    bc.encode(img, p)
    np.testing.assert_array_equal(bc.decode(p), img)
    f32 = str(tmp_path / "f32.l3c")
    codecs["bc"].encode(img, f32)
    assert open(p, "rb").read() != open(f32, "rb").read()


def test_autocrop_part_files(codecs, tmp_path, monkeypatch):
    monkeypatch.setenv("AC_NEEDS_CROP_DIM", "24,24")
    bc = codecs["bc"]
    img = _img(48, 40, 4)
    p = str(tmp_path / "big.l3c")
    bpsp = bc.encode(img, p)
    parts = part_suffix.iter_part_paths(p + ".part0")
    assert len(parts) == 4 and not os.path.exists(p)
    np.testing.assert_array_equal(bc.decode(parts[0]), img)
    sizes = sum(os.path.getsize(q) for q in parts)
    assert sum(bc.last_unit_bytes[0]) == sizes - 4 * (HEADER + 4 * 4)
    assert 0 < bpsp < 30


def test_corrupt_streams_raise(codecs, tmp_path):
    bc = codecs["bc"]
    img = _img(16, 16, 5)
    p = str(tmp_path / "c.l3c")
    bc.encode(img, p)
    blob = open(p, "rb").read()
    n_u = sum(struct.unpack_from("<4I", blob, HEADER))
    sep = HEADER + 16 + n_u                  # unit 0's separator
    assert struct.unpack_from("<I", blob, sep)[0] == 0x4C334353
    cases = {"magic": (0, 0x00), "version": (4, 8), "scales": (5, 2),
             "separator": (sep, 0x00)}
    for name, (i, v) in cases.items():
        bad = bytearray(blob)
        bad[i] = v
        q = str(tmp_path / f"bad_{name}.l3c")
        open(q, "wb").write(bytes(bad))
        with pytest.raises(DecodeError):
            bc.decode(q)
    q = str(tmp_path / "trunc.l3c")
    open(q, "wb").write(blob[:-40])
    with pytest.raises(DecodeError):
        bc.decode(q)


def test_another_evaluator_variant_is_refused(codecs, tmp_path):
    bc = codecs["bc"]
    p = str(tmp_path / "v.l3c")
    bc.encode(_img(16, 16, 6), p)
    bad = bytearray(open(p, "rb").read())
    bad[7] = 2
    q = str(tmp_path / "v2.l3c")
    open(q, "wb").write(bytes(bad))
    with pytest.raises(DecodeError, match="evaluator variant 2"):
        bc.decode(q)


def test_baseline_round_trip(tmp_path):
    """A two-scale RGB baseline (cr_rgb-shaped): unit 0 is the pyramid's
    coarsest image under the uniform coder at L = 256, every scale an RGB
    mixture with the lambda chain; byte-identical to the JAX package's in
    the header and unit 0."""
    common = dict(num_scales=2, Cf=8, rgb_bicubic_baseline=True)
    jc = MsConfig(enc=EncConfig(cls="BicubicSubsampling", num_blocks=1,
                                feed_F=False), dec=DecConfig(num_blocks=1),
                  q=QConfig(C=3, L=5), prob=ProbConfig(K=2), **common)
    tc = tcfg.MsConfig(enc=tcfg.EncConfig(cls="BicubicSubsampling",
                                          num_blocks=1, feed_F=False),
                       dec=tcfg.DecConfig(num_blocks=1),
                       q=tcfg.QConfig(C=3, L=5), prob=tcfg.ProbConfig(K=2),
                       **common)
    jn = JNet(jc)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jn.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(params), strict=True)
    bc = Bitcoding(tc, tn, device="cpu")
    img = np.random.RandomState(21).randint(0, 256, (1, 20, 24, 3)).astype(
        np.uint8)
    pt, pj = str(tmp_path / "t.l3c"), str(tmp_path / "j.l3c")
    bc.encode(img, pt)
    np.testing.assert_array_equal(bc.decode(pt), img)
    JBitcoding(jc, jn, params).encode(img, pj)
    a, b = open(pt, "rb").read(), open(pj, "rb").read()
    n_u = HEADER + 16 + sum(struct.unpack_from("<4I", a, HEADER)) + 4
    assert a[:n_u] == b[:n_u]
    assert bc.unit_scale_map() == ["uniform", "scale_1", "scale_0"]


def test_cross_package_files_measured(codecs, tmp_path):
    bc, jb = codecs["bc"], codecs["jb"]
    from l3c_torch.models import layers
    from l3c_torch.utils import pad as tpad
    # the cause: the packed parameters of one image, scale by scale
    img = _img(32, 32, 2)
    padded, _ = tpad.pad(img, 8, "constant")
    with torch.inference_mode():
        per = bc.net.enc_forward(layers.sub_rgb_mean(
            torch.from_numpy(padded).float()))
    jper = jb._enc_forward(jb.params, jnp.asarray(padded, jnp.float32))
    bn, jbn, F, jF, worst = per[2].bn_q, jper[2][1], None, None, 0.0
    for s in reversed(range(3)):
        with torch.inference_mode():
            F, got = bc._get_P(s, bn, F)
        _, jF, want = jb._get_P[s](jb.params, jbn, jF)
        for a, b in zip(got, want):
            if a is not None:
                b = np.asarray(b)
                worst = max(worst, float(np.abs(a.numpy() - b).max()
                                         / max(np.abs(b).max(), 1e-30)))
        if s:
            bn, jbn = per[s - 1].bn_q, jper[s - 1][1]
    # the files
    rows = []
    for i, (h, w) in enumerate([(20, 24), (17, 30), (32, 32), (64, 64)]):
        im = _img(h, w, i)
        pt, pj = str(tmp_path / f"t{i}.l3c"), str(tmp_path / f"j{i}.l3c")
        bc.encode(im, pt)
        jb.encode(im, pj)
        a, b = open(pt, "rb").read(), open(pj, "rb").read()
        n_u = HEADER + 16 + sum(struct.unpack_from("<4I", a, HEADER)) + 4
        rows.append(dict(
            shape=(h, w), size=len(a), unit0=a[:n_u] == b[:n_u],
            differ=sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)),
            port_reads_jax=np.array_equal(bc.decode(pj), im),
            jax_reads_port=np.array_equal(np.asarray(jb.decode(pt)), im)))
    print(f"v1 across packages, tiny model K=2, CPU: packed parameters "
          f"within {worst:.3g} of each tensor's largest magnitude")
    for r in rows:
        print(f"  {r['shape']}: {r['differ']} of {r['size']} bytes differ, "
              f"header+unit 0 equal {r['unit0']}; the port decodes JAX's "
              f"file to the source {r['port_reads_jax']}, JAX the port's "
              f"{r['jax_reads_port']}")
    assert 0 < worst <= 5e-7
    assert [r["differ"] for r in rows] == [53, 11, 77, 1115]
    assert all(r["unit0"] for r in rows)
    assert not any(r["port_reads_jax"] or r["jax_reads_port"]
                   for r in rows)


# ---------------------------------------------------------------- dispatch


@pytest.fixture(scope="module")
def world(codecs, tmp_path_factory):
    """A log root with the tiny model's checkpoint (written by the port's
    packb) under a trainer-style name, its config root, two PNGs."""
    root = tmp_path_factory.mktemp("v1world")
    cfg_root = root / "configs"
    (cfg_root / "ms").mkdir(parents=True)
    (cfg_root / "dl").mkdir()
    (cfg_root / "ms" / "tiny.cf").write_text(TINY_CF)
    (cfg_root / "dl" / "tinydl.cf").write_text("crop_size = 16\n")
    ckpts = root / "logs" / "0102_0304 tiny tinydl" / "ckpts"
    ckpts.mkdir(parents=True)
    (ckpts / ckpt_name(500, tmp=False)).write_bytes(packb(
        {"params": codecs["params"], "opt_state": {}, "step": 500}))
    imgs = root / "imgs"
    imgs.mkdir()
    for i, (h, w) in enumerate([(20, 24), (17, 30)]):
        write_png(str(imgs / f"im{i}.png"), _img(h, w, 10 + i)[0])
    return dict(logs=str(root / "logs"), cfg_root=str(cfg_root),
                imgs=str(imgs))


def _args(world):
    return ["--config_roots", world["cfg_root"], "--device", "cpu"]


def test_make_bitcoding_and_open_decoder(codecs, tmp_path):
    tc, tn = codecs["tc"], codecs["tn"]
    assert isinstance(tcodec.make_bitcoding(tc, tn, "auto", device="cpu"),
                      TorchBitcoding)
    for name in ("host", "cpu", "v1"):
        assert isinstance(tcodec.make_bitcoding(tc, tn, name, device="cpu",
                                                coder_profile="size"),
                          Bitcoding)
    with pytest.raises(ValueError, match="unknown codec backend"):
        tcodec.make_bitcoding(tc, tn, "tpu", device="cpu")
    p = str(tmp_path / "x.l3c")
    codecs["bc"].encode(_img(16, 16, 7), p)
    assert tcodec.file_version(p) == 2
    assert isinstance(tcodec.open_decoder(p, tc, tn, device="cpu"),
                      Bitcoding)
    bad = bytearray(open(p, "rb").read())
    bad[4] = 5
    open(p, "wb").write(bytes(bad))
    with pytest.raises(DecodeError, match="unsupported format version 5"):
        tcodec.open_decoder(p, tc, tn, device="cpu")


def test_cli_l3c_host_and_v8_through_one_dispatch(world, codecs, tmp_path):
    src = os.path.join(world["imgs"], "im1.png")
    for backend, version in (("host", 2), ("auto", 8)):
        coded = str(tmp_path / f"{backend}.l3c")
        back = str(tmp_path / f"{backend}.png")
        assert l3c_cli.main([world["logs"], "0102", "enc", src, coded,
                             "--codec_backend", backend] + _args(world)) == 0
        assert open(coded, "rb").read()[4] == version
        # dec takes no backend: the file's version byte picks the codec
        assert l3c_cli.main([world["logs"], "0102", "dec", coded, back]
                            + _args(world)) == 0
        np.testing.assert_array_equal(read_png(back), read_png(src))
    # the CLI's v1 file is Bitcoding.encode's, byte for byte
    direct = str(tmp_path / "direct.l3c")
    codecs["bc"].encode(read_png(src)[None], direct)
    assert open(direct, "rb").read() == \
        open(str(tmp_path / "host.l3c"), "rb").read()


def test_tester_write_to_files_and_decode_file(world, tmp_path, capsys):
    out = tmp_path / "out"
    assert test_cli.main([world["logs"], "0102", world["imgs"],
                          "--write_to_files", str(out), "--codec_backend",
                          "host", "--compare_theory"] + _args(world)) == 0
    text = capsys.readouterr().out
    assert text.count("assumed:") == 2
    sizes = [os.path.getsize(out / f"im{i}.l3c") for i in range(2)]
    imgs = [read_png(os.path.join(world["imgs"], f"im{i}.png"))
            for i in range(2)]
    mean = np.mean([s * 8 / im.size for s, im in zip(sizes, imgs)])
    assert text.strip().splitlines()[-1].split()[-1] == f"{mean:.4f}"
    tester = MultiscaleTester.from_log_dir(
        os.path.join(world["logs"], "0102_0304 tiny tinydl"),
        [world["cfg_root"]], use_cache=False, device="cpu")
    assert tester.codec_backend == "auto"
    v8 = str(tmp_path / "v8.l3c")
    tester.encode_file(os.path.join(world["imgs"], "im0.png"), v8)
    for coded in (v8, str(out / "im0.l3c")):
        png = coded + ".png"
        tester.decode_file(coded, png)
        np.testing.assert_array_equal(read_png(png), imgs[0])
