"""The heavy training summaries of l3c_torch (--log_train_heavy) against
the JAX package, on the CPU, at a tiny size.

Held, with the tolerances:
- dmll.mean_symbol_probs within 1e-5 (absolute, of probabilities summing
  to 1) of JAX's at L = 25 (a bottleneck spec) and L = 256 (RGB with the
  lambda chain);
- make_enc_hist: each bin's count equal to JAX's, or off by one where an
  activation lies on a bucket edge in float32 (XLA and PyTorch may round
  (v - lo) / (hi - lo) * bins otherwise there), the totals equal;
- make_ps_stats: p_x (observed counts) equal, p_y within 1e-5 of JAX's,
  for cr's shape and for an RGB baseline (L = 256 at every scale);
- Trainer.train(heavy_every=2) with a recording writer: the same tags as
  JAX's trainer writes (images, histograms, figures, scalars), the
  activation counts summing to the activations; on a baseline the port
  writes the bottleneck images of the pixels (L = 256), where JAX's
  bottleneck_image refuses pixels on the q.L = 5 grid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.config import (DecConfig, DlConfig, EncConfig, MsConfig,
                            ProbConfig, QConfig)
from l3c_tpu.models import dmll as jdmll
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.train import trainer as jtrainer
from l3c_tpu.utils import summarizer as jsumm
from l3c_torch import config as tcfg
from l3c_torch.models import dmll as tdmll
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax
from l3c_torch.train import trainer as ttrainer
from l3c_torch.utils import summarizer as tsumm
from tests.test_utils import FakeWriter

torch.set_num_threads(1)


def tiny(baseline=False):
    """test_training.py's tiny model (or an RGB baseline of its size) in
    both packages, the JAX params carried to the port."""
    if baseline:
        enc = dict(cls="BicubicSubsampling", num_blocks=1, feed_F=False)
        kw = dict(num_scales=2, Cf=8, rgb_bicubic_baseline=True)
        q = dict(C=3, L=5)
    else:
        enc, kw, q = dict(num_blocks=1), dict(num_scales=2, Cf=8), \
            dict(C=2, L=25)
    jc = MsConfig(enc=EncConfig(**enc), dec=DecConfig(num_blocks=1),
                  q=QConfig(**q), prob=ProbConfig(K=2), **kw)
    tc = tcfg.MsConfig(enc=tcfg.EncConfig(**enc),
                       dec=tcfg.DecConfig(num_blocks=1), q=tcfg.QConfig(**q),
                       prob=tcfg.ProbConfig(K=2), **kw)
    jn = JNet(jc)
    params = jax.jit(jn.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jc, jn, params, tc, tn.eval()


def _batch(n=2, h=16, w=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("rgb,L", [(False, 25), (True, 256)])
def test_mean_symbol_probs_matches_jax(rgb, L):
    rng = np.random.RandomState(L)
    C, K = (3, 4) if rgb else (5, 3)
    Kp = (4 if rgb else 3) * C * K
    l = rng.randn(2, 6, 7, Kp).astype(np.float32)
    l.reshape(2, 6, 7, -1, C, K)[..., 1, :, :] *= 60.0 if rgb else 0.5
    l.reshape(2, 6, 7, -1, C, K)[..., 1, :, :] += 128.0 if rgb else 0.0
    if rgb:
        x = rng.randint(0, 256, (2, 6, 7, 3)).astype(np.float32)
        jspec, tspec = jdmll.DMLLSpec(rgb_scale=True), \
            tdmll.DMLLSpec(rgb_scale=True)
    else:
        x = np.linspace(-1, 1, L)[rng.randint(0, L, (2, 6, 7, C))] \
            .astype(np.float32)
        jspec = jdmll.DMLLSpec(rgb_scale=False, x_min=-1.0, x_max=1.0, L=L)
        tspec = tdmll.DMLLSpec(rgb_scale=False, x_min=-1.0, x_max=1.0, L=L)
    want = np.asarray(jax.jit(lambda a, b: jdmll.mean_symbol_probs(
        jspec, a, b))(jnp.asarray(x), jnp.asarray(l)))
    got = tdmll.mean_symbol_probs(tspec, torch.from_numpy(x),
                                  torch.from_numpy(l)).numpy()
    assert got.shape == want.shape == (L,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(float(got.sum()) - 1) < 1e-5 and got.min() >= -1e-7


def test_enc_hist_matches_jax():
    jc, jn, params, tc, tn = tiny()
    batch = _batch(2, 32, 32, 1)
    want = jax.device_get(jax.jit(jtrainer.make_enc_hist(jc, jn))(
        params, jnp.asarray(batch, jnp.float32)))
    got = ttrainer.make_enc_hist(tn)(torch.from_numpy(batch))
    assert set(got) == set(want) == {"histo/enc_1_after_1x1",
                                     "histo/enc_2_after_1x1"}
    for tag in want:
        g, w = got[tag].numpy(), np.asarray(want[tag])
        assert g.shape == w.shape == (ttrainer.HIST_BINS,)
        assert g.sum() == w.sum()
        assert np.abs(g - w).max() <= 1, (tag, g - w)
        print(tag, "bins off by one:", int((g != w).sum()))


@pytest.mark.parametrize("baseline", [False, True])
def test_ps_stats_matches_jax(baseline):
    jc, jn, params, tc, tn = tiny(baseline)
    img = _batch(1, 16, 24, 2)
    want = jax.device_get(jax.jit(jtrainer.make_ps_stats(jc, jn))(
        params, jnp.asarray(img, jnp.float32)))
    got = ttrainer.make_ps_stats(tc, tn)(torch.from_numpy(img))
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        (px_t, py_t), (px_j, py_j) = got[i], want[i]
        L = 256 if i == 0 or baseline else 25
        assert px_t.shape == py_t.shape == (L,)
        np.testing.assert_array_equal(px_t.numpy(), np.asarray(px_j))
        np.testing.assert_allclose(py_t.numpy(), np.asarray(py_j), rtol=0,
                                   atol=1e-5)


def _tags(w):
    return {"images": set(w.images), "histos": set(w.histos),
            "figures": set(w.figures), "scalars": set(w.scalars)}


def test_train_heavy_every_emits_jax_tags():
    """Two steps with heavy_every=2 (tests/test_training.py's heavy
    summary runs): the port's tags are JAX's, the activation histogram of
    scale 1 counts (2, 8, 8, C=2) activations."""
    jc, jn, _, tc, _ = tiny()
    dl = DlConfig(batchsize_train=2, batchsize_val=2, crop_size=16)
    bs = [_batch(seed=s) for s in range(2)]
    wj, wt = FakeWriter(), FakeWriter()
    jt = jtrainer.Trainer(jc, dl, jn, iter(bs), epoch_len=10,
                          summary_writer=wj)
    jt.train(num_itr=2, log_every=1, val_every=0, heavy_every=2,
             log_fn=lambda *_: None)
    tt = ttrainer.Trainer(tc, tcfg.DlConfig(batchsize_train=2,
                                            crop_size=16), TNet(tc),
                          iter(bs), epoch_len=10, summary_writer=wt,
                          device="cpu")
    tt.train(2, log_every=1, val_every=0, heavy_every=2,
             log_fn=lambda *_: None)
    assert _tags(wt) == _tags(wj)
    assert any(k.startswith("train_heavy/bn/") for k in wt.images)
    assert {"train_heavy/histo_out/0", "train_heavy/histo_out/1"} <= set(
        wt.figures)
    counts, edges = wt.histos["train/histo/enc_1_after_1x1"]
    assert counts.sum() == 2 * 8 * 8 * 2 and len(edges) == len(counts) + 1
    for tag, img in wt.images.items():
        assert img.dtype == np.uint8 and img.shape[-1] == 3


def test_baseline_heavy_summaries():
    """An RGB baseline's scales above 0 hold pixels: the port draws their
    images on the 256-level grid and writes every tag (no activation
    histogram: the bicubic encoders have no 1x1 conv). JAX's trainer hands
    bottleneck_image the q.L = 5 grid, which refuses them."""
    _, _, _, tc, _ = tiny(baseline=True)
    w = FakeWriter()
    tt = ttrainer.Trainer(tc, tcfg.DlConfig(batchsize_train=2,
                                            crop_size=16), TNet(tc),
                          iter([_batch(seed=3)] * 2), epoch_len=10,
                          summary_writer=w, device="cpu")
    tt.train(2, log_every=0, val_every=0, heavy_every=1,
             log_fn=lambda *_: None)
    assert {f"train_heavy/bn/1/c{c}" for c in range(3)} <= set(w.images)
    assert "train_heavy/bn_syms/1" in w.histos
    assert not any("after_1x1" in k for k in w.histos)
    assert {"train_heavy/histo_out/0", "train_heavy/histo_out/1"} <= set(
        w.figures)
    pixels = np.full((4, 4), 200)
    with pytest.raises(AssertionError):
        jsumm.bottleneck_image(pixels, 5)
    with pytest.raises(ValueError, match="not in"):
        tsumm.bottleneck_image(pixels, 5)
    np.testing.assert_array_equal(tsumm.bottleneck_image(pixels, 256),
                                  jsumm.bottleneck_image(pixels, 256))


def test_summary_helpers_equal_jax(tmp_path):
    """to_image, symbol_histogram and the SafeWriter calls (no-ops without
    tensorboard, event files with it)."""
    rng = np.random.RandomState(0)
    for arr in (rng.randn(5, 7), rng.randint(0, 9, (4, 6, 1)),
                rng.randint(0, 256, (3, 4, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(tsumm.to_image(arr),
                                      jsumm.to_image(arr))
    syms = rng.randint(0, 25, 300)
    np.testing.assert_array_equal(tsumm.symbol_histogram(syms, 25),
                                  jsumm.symbol_histogram(syms, 25))
    sw = tsumm.SafeWriter(str(tmp_path))
    sw.add_image("i", rng.randn(4, 4), 1)
    sw.add_histogram("h", rng.randn(50), 1)
    sw.add_histogram_counts("c", np.arange(4), np.linspace(0, 1, 5), 1)
    sw.add_histogram_counts("z", np.zeros(4), np.linspace(0, 1, 5), 1)
    sw.add_figure("f", tsumm.ps_figure(np.arange(5), np.full(5, 0.2)), 1)
    sw.close()
    off = tsumm.SafeWriter.__new__(tsumm.SafeWriter)
    off._w = None
    off.add_image("i", np.zeros((2, 2)), 1)
    off.add_histogram_counts("c", np.ones(2), np.linspace(0, 1, 3), 1)
    off.close()
