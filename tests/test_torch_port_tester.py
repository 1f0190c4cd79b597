"""The port's serving entry points (cli/l3c.py, cli/test.py, eval/tester.py,
stage_batch / verify_batch) against the JAX package's, on the CPU.

One tmp log directory, named as the trainer names them, holds two tiny
checkpoints written by the JAX package's `Saver`; a tmp config root holds
the tiny `.cf` its name mentions. Both packages' testers are built from it
through `from_log_dir`. The images are PNGs from a numpy seed, written by
the port's writer (the JAX package reads them with Pillow).

Held, with the tolerances:
- `encode_file` through both packages: byte-identical `.l3c` (the canaries
  agree on the CPU), each package decodes the other's file to the source
  pixels;
- `test`: per-image bpsp within 1e-5 relative of the float64 sum of the
  JAX package's per-element NLL (its own float32 total under jit is off by
  up to ~4e-5, so that is held to 1e-4), auto-crop and `--crop` included;
- `write_to_files` (size profile, all K components, groups by shape):
  files byte-identical to the JAX package's, so bpsp equal exactly, and
  each package decodes the other's files to the source pixels (at this
  size the two float pack stages round every entry alike; what they
  differ by at large sizes is in ROADMAP.md section 3);
- `verify_batch`: flag true and the u32 hash equal to the JAX package's
  `verify_batch_finish` and to the hash computed with numpy;
- the options once refused now run (--sample, --recursive, the host
  codec, --fanout and --spatial_shard over several cpu device slots), and
  the CLIs raise without a card unless `--device cpu`.

The JAX side runs jitted, once per module.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu import blueprint as jbp
from l3c_tpu.codec.bitcoding2 import TpuBitcoding
from l3c_tpu.eval.tester import MultiscaleTester as JTester
from l3c_tpu.models import dmll as jdmll
from l3c_tpu.train.saver import Saver
from l3c_tpu.utils import pad as jpad
from l3c_torch.cli import l3c as l3c_cli
from l3c_torch.cli import test as test_cli
from l3c_torch.codec.bitcoding2 import TorchBitcoding, content_hash
from l3c_torch.data.images import Testset as ImageSet
from l3c_torch.data.images import load_image_uint8, read_png, write_png
from l3c_torch.eval import tester as tester_mod
from l3c_torch.eval.tester import EncodeError, MultiscaleTester
from l3c_torch.eval.timer import NoOpTimer, StackTimer
from l3c_torch.models.weights import params_from_jax
from l3c_torch.utils.printer import AlignedPrinter

torch.set_num_threads(1)

TINY_CF = ("num_scales = 3\nCf = 8\nenc.num_blocks = 1\ndec.num_blocks = 1\n"
           "q.C = 5\nq.L = 25\nprob.K = 2\n")
LOG_NAME = "0102_0304 tiny tinydl r@0101_0000 note"


def _img(h, w, seed):
    """Gradients plus noise (compressible, so streams differ in length)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 5, xx * 7, (yy + xx) * 3], -1)
    return ((base + rng.randint(0, 24, base.shape)) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(log root, config root, image dir, {itr: flax params}, JAX tester,
    port tester)."""
    root = tmp_path_factory.mktemp("serving")
    cfg_root = root / "configs"
    (cfg_root / "ms").mkdir(parents=True)
    (cfg_root / "dl").mkdir()
    (cfg_root / "ms" / "tiny.cf").write_text(TINY_CF)
    (cfg_root / "dl" / "tinydl.cf").write_text("crop_size = 16\n")
    log_dir = root / "logs" / LOG_NAME
    log_dir.mkdir(parents=True)
    img_dir = root / "imgs"
    img_dir.mkdir()
    for i, (h, w) in enumerate([(20, 24), (20, 24), (20, 24), (17, 30)]):
        write_png(str(img_dir / f"im{i}.png"), _img(h, w, i))

    params = {}
    saver = Saver(str(log_dir))
    from l3c_tpu.config import load_ms_config
    from l3c_tpu.models.network import MultiscaleNetwork as JNet
    jn = JNet(load_ms_config(str(cfg_root / "ms" / "tiny.cf")))
    for itr, seed in ((250, 1), (500, 0)):
        params[itr] = jax.jit(jn.init)(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, 16, 16, 3)))
        saver.save({"params": params[itr], "opt_state": {}, "step": itr},
                   itr)
    jt = JTester.from_log_dir(str(log_dir), [str(cfg_root)], use_cache=False)
    tt = MultiscaleTester.from_log_dir(str(log_dir), [str(cfg_root)],
                                       use_cache=False, device="cpu")
    return dict(logs=str(root / "logs"), cfg_root=str(cfg_root),
                log_dir=str(log_dir), imgs=str(img_dir), params=params,
                jt=jt, tt=tt)


def _cli_args(world):
    return ["--config_roots", world["cfg_root"], "--device", "cpu"]


def test_from_log_dir_restores_the_savers_checkpoints(world):
    """The configs come from the log dir's name, the weights from the
    checkpoint of the asked iteration (the newest for -1)."""
    tt = world["tt"]
    assert tt.restore_itr == world["jt"].restore_itr == 500
    assert (tt.cfg.Cf, tt.cfg.prob.K, tt.cfg.enc.num_blocks) == (8, 2, 1)
    t250 = MultiscaleTester.from_log_dir(
        world["log_dir"], [world["cfg_root"]], restore_itr=300,
        use_cache=False, device="cpu")
    assert t250.restore_itr == 250
    for t, itr in ((tt, 500), (t250, 250)):
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, world["params"][itr]))
        got = t.net.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    sd, sd250 = tt.net.state_dict(), t250.net.state_dict()
    assert any(not torch.equal(sd[k], sd250[k]) for k in sd)
    with pytest.raises(ValueError, match="no ms config"):
        MultiscaleTester.from_log_dir(world["log_dir"], [world["imgs"]],
                                      device="cpu")


def test_cli_enc_dec_byte_identical_to_jax_and_cross_decode(world, tmp_path,
                                                            capsys):
    src = os.path.join(world["imgs"], "im3.png")      # 17x30: padded
    pt, pj = str(tmp_path / "port.l3c"), str(tmp_path / "jax.l3c")
    args = [world["logs"], "0102_0304"]
    assert l3c_cli.main(args + ["enc", src, pt] + _cli_args(world)) == 0
    out = capsys.readouterr().out
    assert "encoded" in out and "bpsp" in out
    bpsp_j = world["jt"].encode_file(src, pj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert f"{bpsp_j:.4f} bpsp" in out
    # an existing output is refused unless --overwrite
    with pytest.raises(EncodeError, match="exists"):
        l3c_cli.main(args + ["enc", src, pt] + _cli_args(world))
    assert l3c_cli.main(args + ["enc", src, pt, "-f"]
                        + _cli_args(world)) == 0
    assert open(pt, "rb").read() == open(pj, "rb").read()
    # each package decodes the other's file
    png_t, png_j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert l3c_cli.main(args + ["dec", pj, png_t] + _cli_args(world)) == 0
    world["jt"].decode_file(pt, png_j)
    want = read_png(src)
    np.testing.assert_array_equal(read_png(png_t), want)
    np.testing.assert_array_equal(read_png(png_j), want)


def _bpsp64(jt, img):
    """bpsp of one (1,H,W,3) uint8 image from the JAX network's outputs,
    its per-element NLL summed in float64."""
    cfg = jt.cfg
    padded, _ = jpad.pad(img, cfg.padding_fac, mode="constant")
    out = jax.jit(lambda p, x: jt.net.apply(p, x, train=False))(
        jt.params, jnp.asarray(padded, jnp.float32))
    S = cfg.num_scales
    specs = [jbp.rgb_spec(cfg)] + [jbp.bn_spec(cfg)] * (S - 1)
    targets = [np.asarray(out.S[0], np.float32)] + \
        [np.asarray(out.bn[i]) for i in range(1, S)]
    nats = sum(np.asarray(jdmll.nll(s, jnp.asarray(x), out.P[i]),
                          np.float64).sum()
               for i, (s, x) in enumerate(zip(specs, targets)))
    nats += float(jbp.uniform_tail_nats(cfg, out, S))
    return nats / (np.log(2.0) * img.size)


def test_bpsp_eval_against_jax(world, capsys):
    """cli.test without --write_to_files: the theory bpsp per image."""
    ts = ImageSet(world["imgs"])
    got = world["tt"].test(ts)
    from l3c_tpu.data.images import Testset as JImageSet
    want = world["jt"].test(JImageSet(world["imgs"]))
    assert sorted(got.per_img) == sorted(want.per_img) \
        == [f"im{i}.png" for i in range(4)]
    for name in got.per_img:
        img = load_image_uint8(os.path.join(world["imgs"], name))[None]
        ref = _bpsp64(world["jt"], img)
        assert abs(got.per_img[name] - ref) / ref < 1e-5, name
        assert abs(got.per_img[name] - want.per_img[name]) \
            / want.per_img[name] < 1e-4, name
    assert test_cli.main([world["logs"], "0102", world["imgs"], "--names",
                          "seeded", "--reset_cache"] + _cli_args(world)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].split() == ["log_dir", "itr", "testset", "bpsp"]
    assert lines[-1].split()[-3:] == ["500", "seeded_4",
                                      f"{got.mean_bpsp():.4f}"]
    assert lines[-1].startswith(LOG_NAME)


def test_bpsp_eval_crop_and_autocrop_against_jax(world, monkeypatch):
    """--crop (centre crop) and images above the auto-crop threshold (the
    tiles' bpsp combined by their subpixels)."""
    from l3c_tpu.data.images import Testset as JImageSet
    one = os.path.join(world["imgs"], "im0.png")
    kw = dict(use_cache=False, crop=16)
    tt = MultiscaleTester(world["tt"].cfg, world["tt"].net, device="cpu",
                          **kw)
    jt = JTester(world["jt"].cfg, world["jt"].net, world["jt"].params, **kw)
    got, want = tt.test(ImageSet(one)), jt.test(JImageSet(one))
    ref = _bpsp64(world["jt"], tt._load(one))
    assert tt._load(one).shape == (1, 16, 16, 3)
    assert abs(got.mean_bpsp() - ref) / ref < 1e-5
    assert abs(got.mean_bpsp() - want.mean_bpsp()) / want.mean_bpsp() < 1e-4
    monkeypatch.setenv("AC_NEEDS_CROP_DIM", "16,16")
    got = world["tt"].test(ImageSet(one))
    want = world["jt"].test(JImageSet(one))
    assert abs(got.mean_bpsp() - want.mean_bpsp()) / want.mean_bpsp() < 1e-4
    assert got.mean_bpsp() != pytest.approx(ref, rel=1e-3)   # tiles, not one


def test_write_to_files_equals_jax_exactly(world, tmp_path, capsys):
    """cli.test --write_to_files --compare_theory: size profile, topk 0
    (all K components), three same-shape images as one group and the
    fourth alone; the files are the JAX package's byte for byte, and each
    package decodes the other's."""
    from l3c_tpu.data.images import Testset as JImageSet
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    report = str(tmp_path / "times.txt")
    assert test_cli.main([world["logs"], "0102_0304", world["imgs"],
                          "--write_to_files", dt, "--compare_theory",
                          "--time_report", report] + _cli_args(world)) == 0
    out = capsys.readouterr().out
    want = world["jt"].write_to_files(JImageSet(world["imgs"]), dj)
    names = [f"im{i}" for i in range(4)]
    same_bytes = {}
    for n in names:
        a = open(os.path.join(dt, n + ".l3c"), "rb").read()
        b = open(os.path.join(dj, n + ".l3c"), "rb").read()
        same_bytes[n] = a == b
        assert len(a) == len(b) and a[:24] == b[:24], n     # the header
        assert a[6] == (4 if n != "im3" else 1)   # fbatch of a group of 3
        assert a[7] == 0                               # topk 0: size profile
        h, w = (20, 24) if n != "im3" else (17, 30)
        assert want.per_img[n + ".png"] == len(a) * 8 / (h * w * 3)
    assert f"{want.mean_bpsp():.4f}" in out.strip().splitlines()[-1]
    # the streams at topk 0: byte for byte, and each package decodes the
    # other's files (the group of three together, the fourth alone)
    print(f"write_to_files vs JAX, files byte-identical: {same_bytes}")
    assert all(same_bytes.values()), same_bytes
    srcs = [read_png(os.path.join(world["imgs"], n + ".png"))[None]
            for n in names]
    bc = TorchBitcoding(world["tt"].cfg, world["tt"].net, device="cpu")
    jt = world["jt"]
    jb = TpuBitcoding(jt.cfg, jt.net, jt.params)
    for group in (names[:3], names[3:]):
        from_jax = bc.decode_batch([os.path.join(dj, n + ".l3c")
                                    for n in group])
        from_port = jb.decode_batch([os.path.join(dt, n + ".l3c")
                                     for n in group])
        for n, x, y in zip(group, from_jax, from_port):
            np.testing.assert_array_equal(x, srcs[names.index(n)], n)
            np.testing.assert_array_equal(np.asarray(y),
                                          srcs[names.index(n)], n)
    # --compare_theory: per image three lines; the assumed bitrates are
    # the per-unit bytes of the file
    assert out.count("bitrates:") == 4 and out.count("assumed:") == 4
    assert out.count("incl. header]") == 4
    rep = open(report).read()
    for scope in ("enc:", "dec:", "[0]/get_P", "[2]/lookups+rans",
                  "uniform decode", "fetch images", "write:"):
        assert scope in rep, rep
    # written again over the old files, grouped by two: other bytes (the
    # group's fbatch is in the header), the same images back
    res = world["tt"].write_to_files(ImageSet(world["imgs"]), dt, group=2)
    assert sorted(res.per_img) == [n + ".png" for n in names]
    assert open(os.path.join(dt, "im0.l3c"), "rb").read()[6] == 2


def test_k10_files_against_jax_gap_recorded(tmp_path):
    """The gap ROADMAP.md section 3 records, measured: with all K = 10
    components (the size profile) at 64x64 the two packages' CPU float
    pack stages (XLA's exp against PyTorch's) round single IntParams
    entries otherwise, under EQUAL header canaries: the canary's 128
    pixels do not reach them. Files then differ in a few stream bytes and
    the other package decodes them, unrefused, to other pixels. Held here:
    the canaries are equal; each package decodes its own files bit-exactly;
    a file crosses correctly exactly when it is byte-identical. The counts
    are printed, not held: they depend on the CPU's float libraries."""
    from l3c_tpu.config import load_ms_config as jload
    from l3c_tpu.models.network import MultiscaleNetwork as JNet
    from l3c_torch.config import load_ms_config
    from l3c_torch.models.network import MultiscaleNetwork
    cf = tmp_path / "k10.cf"
    cf.write_text(TINY_CF.replace("prob.K = 2", "prob.K = 10"))
    jc, tc = jload(str(cf)), load_ms_config(str(cf))
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))
    net = MultiscaleNetwork(tc)
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)))
    jb = TpuBitcoding(jc, jn, params, coder_profile="size")
    tb = TorchBitcoding(tc, net, device="cpu", coder_profile="size")
    imgs = [_img(64, 64, i)[None] for i in range(4)]
    pj = [str(tmp_path / f"j{i}.l3c") for i in range(4)]
    pt = [str(tmp_path / f"t{i}.l3c") for i in range(4)]
    jb.encode_batch(imgs, pj)
    tb.encode_batch(imgs, pt)
    files = [(open(a, "rb").read(), open(b, "rb").read())
             for a, b in zip(pj, pt)]
    for a, b in files:
        assert a[:12] == b[:12] and a[7] == 0      # header, canary; topk 0
    for out, img in zip(tb.decode_batch(pt), imgs):
        np.testing.assert_array_equal(out, img)
    for out, img in zip(jb.decode_batch(pj), imgs):
        np.testing.assert_array_equal(np.asarray(out), img)
    same = [a == b for a, b in files]
    n_bytes = [sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
               for a, b in files]
    port_reads_jax = [np.array_equal(o, i)
                      for o, i in zip(tb.decode_batch(pj), imgs)]
    jax_reads_port = [np.array_equal(np.asarray(o), i)
                      for o, i in zip(jb.decode_batch(pt), imgs)]
    print(f"K=10 size profile 4 x 64x64: byte-identical {same}, bytes "
          f"differing {n_bytes} of {[len(a) for a, _ in files]}; the port "
          f"decodes JAX's right {port_reads_jax}, JAX the port's "
          f"{jax_reads_port}")
    for s_, a, b in zip(same, port_reads_jax, jax_reads_port):
        assert not s_ or (a and b)


def test_write_to_files_autocrop_and_gate(world, tmp_path, monkeypatch,
                                          capsys):
    """Above the auto-crop threshold an image goes alone through
    encode/decode with part files; a decoder that returns other pixels
    trips the bit-exact gate."""
    tt = world["tt"]
    one = ImageSet(os.path.join(world["imgs"], "im0.png"))
    with monkeypatch.context() as m:
        m.setenv("AC_NEEDS_CROP_DIM", "16,16")
        res = tt.write_to_files(one, str(tmp_path / "parts"),
                                compare_theory=True)
        assert sorted(os.listdir(tmp_path / "parts")) == [
            f"im0.l3c.part{i}" for i in range(4)]
        total = sum(os.path.getsize(tmp_path / "parts" / f)
                    for f in os.listdir(tmp_path / "parts"))
        assert res.per_img["im0.png"] == pytest.approx(
            total * 8 / (20 * 24 * 3))
        assert "assumed:" in capsys.readouterr().out

    def wrong(self, pins, float_rows=False):
        outs = TorchBitcoding.decode_batch_finish(
            self, self.decode_batch_async(pins, float_rows))
        outs[-1] = outs[-1] ^ 1
        return outs

    monkeypatch.setattr(TorchBitcoding, "decode_batch", wrong)
    with pytest.raises(EncodeError, match="mismatch"):
        tt.write_to_files(one, str(tmp_path / "gate"))


def _np_hash(px: np.ndarray) -> int:
    flat = px.reshape(-1).astype(np.uint64)
    w = ((np.arange(flat.size, dtype=np.uint64) * np.uint64(2654435761))
         & np.uint64(0xFFFFFFFF)) | np.uint64(1)
    return int((flat * w).sum() & np.uint64(0xFFFFFFFF))


def test_staged_round_and_verify_hash_equal_jax(world, tmp_path):
    """stage_batch -> encode_batch(staged=) -> decode left on the device
    -> verify_batch: the flag is true, the hash is the JAX package's and
    numpy's for the same pixels; files equal the unstaged encode's."""
    tt, jt = world["tt"], world["jt"]
    imgs = [_img(20, 24, 40 + i)[None] for i in range(3)]
    bc = TorchBitcoding(tt.cfg, tt.net, device="cpu")
    staged = bc.stage_batch(imgs)
    assert staged["x"].shape == (4, 24, 24, 3) and staged["B"] == 3
    paths = [str(tmp_path / f"s{i}.l3c") for i in range(3)]
    bpsps = bc.encode_batch(None, paths, staged=staged)
    plain = [str(tmp_path / f"p{i}.l3c") for i in range(3)]
    assert bc.encode_batch(imgs, plain) == bpsps
    for a, b in zip(paths, plain):
        assert open(a, "rb").read() == open(b, "rb").read()
    handle = bc.decode_batch_async(paths)
    assert isinstance(handle["imgs"], torch.Tensor)
    assert handle["imgs"].shape == staged["x"].shape
    ok, h = bc.verify_batch(handle, staged)
    assert ok is True
    assert h == _np_hash(staged["x"].numpy())
    assert h == int(content_hash(staged["x"].reshape(-1)))
    for im, out in zip(imgs, bc.decode_batch_finish(handle)):
        np.testing.assert_array_equal(out, im)
    # unit bytes: what --compare_theory reads
    assert bc.unit_scale_map() == ["uniform", "scale_2", "scale_1",
                                   "scale_0", "scale_0"]
    assert len(bc.last_unit_bytes) == 3
    assert all(len(u) == 5 and min(u) > 0 for u in bc.last_unit_bytes)
    # the JAX package on the same images
    jb = TpuBitcoding(jt.cfg, jt.net, jt.params)
    jstaged = jb.stage_batch(imgs)
    jpaths = [str(tmp_path / f"j{i}.l3c") for i in range(3)]
    jb.encode_batch_finish(jb.encode_batch_async(None, jpaths,
                                                 staged=jstaged))
    for a, b in zip(paths, jpaths):
        assert os.path.getsize(a) == os.path.getsize(b)
    j_ok, j_h = jb.verify_batch_finish(jb.verify_batch_async(
        jb.decode_batch_async(paths), jstaged))
    assert (j_ok, j_h) == (True, h)
    assert jb.last_unit_bytes == bc.last_unit_bytes
    assert jb.unit_scale_map() == bc.unit_scale_map()
    # a decoded batch that differs: flag false, another hash
    handle["imgs"] = handle["imgs"].clone()
    handle["imgs"][1, 3, 5, 2] ^= 1
    bad_ok, bad_h = bc.verify_batch(handle, staged)
    assert bad_ok is False and bad_h != h
    with pytest.raises(ValueError, match="staged"):
        bc.verify_batch(dict(imgs=handle["imgs"][:2]), staged)
    with pytest.raises(ValueError, match="imgs or staged"):
        bc.encode_batch(None, paths)


def test_result_cache_and_lock(world, tmp_path):
    """Results are cached per (testset id, iteration) under the log dir,
    put() keeps what another tester stored meanwhile."""
    tt = world["tt"]
    log_dir = str(tmp_path)
    ts = ImageSet(os.path.join(world["imgs"], "im1.png"))
    t1 = MultiscaleTester(tt.cfg, tt.net, log_dir=log_dir, restore_itr=500,
                          device="cpu")
    res = t1.test(ts)
    assert tester_mod.TestID(ts.id, 500) in t1.cache
    t2 = MultiscaleTester(tt.cfg, tt.net, log_dir=log_dir, restore_itr=500,
                          device="cpu")
    t2._bpsp_of_image = None                     # a hit computes nothing
    assert t2.test(ts).per_img == res.per_img
    assert t2.test_all([ts]) == [(ts.id, res.mean_bpsp())]
    a, b = tester_mod.TestOutputCache(log_dir), tester_mod.TestOutputCache(log_dir)
    ra, rb = tester_mod.TestResult(), tester_mod.TestResult()
    ra["x.png"], rb["y.png"] = 1.0, 2.0
    a.put(tester_mod.TestID("a_1", 1), ra)
    b.put(tester_mod.TestID("b_1", 1), rb)
    assert a.get(tester_mod.TestID("b_1", 1)).per_img == {"y.png": 2.0}
    assert b.get(tester_mod.TestID("a_1", 1)).per_img == {"x.png": 1.0}
    assert a.get(tester_mod.TestID("c_1", 1)) is None
    assert os.path.basename(a.path) != "test_outputs.pkl"   # not JAX's file


@pytest.mark.parametrize("extra,match", [
    # the ids of the cases before --sample and --recursive were ported;
    # items 12 and 13 are ported since: each case now holds the option's
    # path
    pytest.param(["--fanout", "--write_to_files"], "item 13",
                 id="extra1-item 13"),
    pytest.param(["--spatial_shard"], "item 13", id="extra2-item 13"),
    pytest.param(["--codec_backend", "host"], "item 12",
                 id="extra4-item 12"),
])
def test_cli_options_not_ported_raise(world, extra, match, tmp_path,
                                      monkeypatch, capsys):
    from l3c_tpu.data.images import Testset as JImageSet
    from l3c_torch.parallel import mesh
    if extra[0] == "--fanout":
        # two cpu slots: the groups are dealt over two codecs; every file
        # is byte-identical to the JAX package's --fanout file
        monkeypatch.setattr(mesh, "local_devices",
                            lambda device=None: [torch.device("cpu")] * 2)
        out, dj = tmp_path / "fan", str(tmp_path / "jax")
        assert test_cli.main([world["logs"], "0102", world["imgs"]] + extra
                             + [str(out), "--eval_batch", "2"]
                             + _cli_args(world)) == 0
        world["jt"].write_to_files(JImageSet(world["imgs"]), dj, group=2,
                                   fanout=True)
        files = sorted(os.listdir(out))
        assert files == sorted(os.listdir(dj)) and len(files) == 4
        for f in files:
            assert open(out / f, "rb").read() == open(
                os.path.join(dj, f), "rb").read(), f
        return
    if extra[0] == "--spatial_shard":
        # eight cpu slots, as the JAX package's eight CPU devices, and a
        # crop threshold every image exceeds: each image's bpsp is JAX's
        # height-sharded bpsp within 1e-5 (float32 sums)
        monkeypatch.setenv("AC_NEEDS_CROP_DIM", "16,16")
        monkeypatch.setattr(mesh, "local_devices",
                            lambda device=None: [torch.device("cpu")] * 8)
        got = []
        orig = MultiscaleTester._spatial_bpsp
        monkeypatch.setattr(MultiscaleTester, "_spatial_bpsp",
                            lambda self, img: got.append(orig(self, img))
                            or got[-1])
        assert test_cli.main([world["logs"], "0102", world["imgs"],
                              "--reset_cache"] + extra
                             + _cli_args(world)) == 0
        shown = capsys.readouterr().out.strip().splitlines()[-1].split()[-1]
        jt = JTester.from_log_dir(world["log_dir"], [world["cfg_root"]],
                                  use_cache=False, spatial_shard=True)
        want = jt.test(JImageSet(world["imgs"]))
        assert len(got) == 4 and jt._spatial_cache
        for g, w in zip(got, [want.per_img[f"im{i}.png"] for i in range(4)]):
            assert g == pytest.approx(w, rel=1e-5)
        assert shown == f"{np.mean(got):.4f}"
        return
    if match == "item 12":
        out = tmp_path / "v1"
        assert test_cli.main([world["logs"], "0102", world["imgs"]] + extra
                             + ["--write_to_files", str(out)]
                             + _cli_args(world)) == 0
        files = sorted(os.listdir(out))
        assert files and all(open(out / f, "rb").read(5)[4] == 2
                             for f in files)          # format v1's byte
        return
    with pytest.raises(NotImplementedError, match=match):
        test_cli.main([world["logs"], "0102", world["imgs"]] + extra
                      + _cli_args(world))


@pytest.mark.parametrize("option", ["--sample", "--recursive"])
def test_cli_options_ported_run(world, tmp_path, option, capsys):
    """--sample and --recursive, once refused: --sample writes the three
    scale sets' samples of each image beside the table; --recursive 2 on
    the tiny (non-baseline) model evaluates two more applications of its
    last scale, a bpsp of its own, and --write_to_files refuses it."""
    argv = [world["logs"], "0102", os.path.join(world["imgs"], "im3.png"),
            "--reset_cache"] + _cli_args(world)
    if option == "--sample":
        out = tmp_path / "samples"
        assert test_cli.main(argv + ["--sample", str(out)]) == 0
        assert sorted(os.listdir(out)) == [
            "im3_sample.png", "im3_sample0.png", "im3_sample0_1.png"]
        assert read_png(str(out / "im3_sample0.png")).shape == (24, 32, 3)
        return
    assert test_cli.main(argv) == 0
    plain = capsys.readouterr().out.strip().splitlines()[-1].split()[-1]
    assert test_cli.main(argv + ["--recursive", "2"]) == 0
    rec = capsys.readouterr().out.strip().splitlines()[-1].split()[-1]
    assert float(rec) > 0 and rec != plain
    with pytest.raises(NotImplementedError, match="--recursive"):
        test_cli.main(argv + ["--recursive", "2", "--write_to_files",
                              str(tmp_path / "o")])


def test_entry_points_raise_without_a_card_or_a_runnable_config(world,
                                                                tmp_path):
    src = os.path.join(world["imgs"], "im0.png")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            l3c_cli.main([world["logs"], "0102", "enc", src,
                          str(tmp_path / "o.l3c"), "--config_roots",
                          world["cfg_root"]])
        with pytest.raises(RuntimeError, match="CUDA"):
            test_cli.main([world["logs"], "0102", world["imgs"],
                           "--config_roots", world["cfg_root"]])
        with pytest.raises(RuntimeError, match="CUDA"):
            l3c_cli.main([world["logs"], "0102", "enc", src,
                          str(tmp_path / "o.l3c"), "--config_roots",
                          world["cfg_root"], "--device", "cuda"])
    assert not os.path.exists(tmp_path / "o.l3c")
    # a log dir of a baseline config (runnable since the RGB baselines
    # were ported) without checkpoints
    logs = tmp_path / "logs"
    (logs / "0303_0000 cr_rgb_shared oi_offline" / "ckpts").mkdir(
        parents=True)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        l3c_cli.main([str(logs), "0303", "enc", src, str(tmp_path / "o.l3c"),
                      "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no log dir"):
        l3c_cli.main([str(logs), "0404", "enc", src, str(tmp_path / "o.l3c"),
                      "--device", "cpu"])
    (logs / "0505_0000 cr oi_offline").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        l3c_cli.main([str(logs), "0505", "dec", src, str(tmp_path / "o.png"),
                      "--device", "cpu"])
    world["tt"].sample(ImageSet(os.path.join(world["imgs"], "im0.png")),
                       str(tmp_path / "s"), sample_scale_sets=((),))
    assert os.listdir(tmp_path / "s") == ["im0_sample.png"]
    with pytest.raises(ValueError, match="unknown codec backend"):
        MultiscaleTester(world["tt"].cfg, world["tt"].net, device="cpu",
                         codec_backend="tpu")
    # spatial sharding needs more than one device slot; one cpu slot keeps
    # the auto-crop path
    assert not MultiscaleTester(world["tt"].cfg, world["tt"].net,
                                device="cpu", spatial_shard=True).spatial_shard


def test_timer_and_printer_equal_jax(monkeypatch):
    """StackTimer's report format and warm-up rule and AlignedPrinter's
    table are the JAX package's, fed the same clock."""
    from l3c_tpu.eval.timer import StackTimer as JTimer
    from l3c_tpu.utils.printer import AlignedPrinter as JPrinter
    import time
    reports = []
    for cls in (StackTimer, JTimer):
        clock = iter(np.arange(0.0, 100.0, 0.125))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        t = cls(skip=0)
        for _ in range(3):
            with t.run("enc"):
                with t.prefix_scope("[0]"):
                    with t.run("get_P"):
                        pass
                    with t.run("rans"):
                        next(clock)
            t.next_iteration()
        with t.run("once"):
            pass
        reports.append((t.report(), t.report("last"), t.means(), t.lasts()))
    assert reports[0] == reports[1]
    assert "  [0]/get_P: 125.0ms" in reports[0][0]
    assert NoOpTimer().report() == "" and NoOpTimer().means() == {}
    with NoOpTimer().prefix_scope("a"), NoOpTimer().run("b"):
        pass
    tables = []
    for cls in (AlignedPrinter, JPrinter):
        p = cls()
        p.append("log_dir", "itr", "bpsp")
        p.append("0102_0304 tiny", 500, "4.1234")
        tables.append(str(p))
    assert tables[0] == tables[1] and str(AlignedPrinter()) == ""
