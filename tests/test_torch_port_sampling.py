"""Sampling in l3c_torch (dmll.sample, MultiscaleNetwork.sample_forward,
MultiscaleTester.sample, cli.test --sample) against the JAX package, on
the CPU. torch's generators are not JAX's, so distributions are held, not
draws, except where the mixture is made degenerate:

- dmll.sample: shapes, and after the lambda chain every RGB value in
  [0, 255];
- 20,000 draws a pixel on 64 pixels (K = 3, log-scales in [-1, 0.5]): the
  rounded R channel's histogram of each pixel within total variation 0.03
  of exp(-nll) over 0..255; G and B (the lambda chain on the drawn R and
  G) against JAX's own 20,000 draws from the same l: each pixel's mean
  within 5 pooled standard errors, its histogram within total variation
  0.04;
- sample_forward for the scale sets (), (0,) and (0, 1) against JAX's with
  the classifiers' 1x1 projections zeroed and biases that make component 0
  dominate (logit +50 against 0) at log-scale -7 (the floor): every draw
  is then the mixture mean (lambda-shifted) plus a logistic draw of at
  most d = e^-7 ln((1 - 1e-5) / 1e-5) ~ 0.0105, so the packages agree
  within 2d, times (1 + lambda_gr) for G and (1 + lambda_br + lambda_bg
  (1 + lambda_gr)) for B;
- one generator seed gives the same draws twice;
- cli.test --sample writes the JAX package's file names, at the padded
  images' size.
"""
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l3c_tpu.config import (DecConfig, EncConfig, MsConfig, ProbConfig,
                            QConfig)
from l3c_tpu.eval.tester import MultiscaleTester as JTester
from l3c_tpu.models import dmll as jdmll
from l3c_tpu.models.network import MultiscaleNetwork as JNet
from l3c_tpu.train.saver import Saver
from l3c_torch import config as tcfg
from l3c_torch.cli import test as test_cli
from l3c_torch.data.images import read_png, write_png
from l3c_torch.models import dmll as tdmll
from l3c_torch.models.network import MultiscaleNetwork as TNet
from l3c_torch.models.weights import params_from_jax

torch.set_num_threads(1)

RGB = tdmll.DMLLSpec(rgb_scale=True)
N_DRAWS, K = 20000, 3
U_TAIL = math.log((1 - 1e-5) / 1e-5)        # the largest |logit(u)|


def mixture_l(seed, H=8, W=8, K=K, C=3, rgb=True):
    """(1,H,W,Kp) float32 mixture parameters: pi logits N(0, 1), means in
    [40, 215] (RGB) or [-0.8, 0.8], log-scales in [-1, 0.5] (RGB) or
    [-4, -2], lambda logits N(0, 1)."""
    rng = np.random.RandomState(seed)
    P = 4 if rgb else 3
    l = np.zeros((1, H, W, P, C, K), np.float32)
    l[..., 0, :, :] = rng.randn(1, H, W, C, K)
    l[..., 1, :, :] = (rng.uniform(40, 215, (1, H, W, C, K)) if rgb else
                       rng.uniform(-0.8, 0.8, (1, H, W, C, K)))
    l[..., 2, :, :] = (rng.uniform(-1, 0.5, (1, H, W, C, K)) if rgb else
                       rng.uniform(-4, -2, (1, H, W, C, K)))
    if rgb:
        l[..., 3, :, :] = rng.randn(1, H, W, C, K)
    return l.reshape(1, H, W, P * C * K)


def port_draws(l, n, seed=0, chunk=2000):
    """(n, H, W, 3) draws of the port from l (1,H,W,Kp)."""
    g = torch.Generator().manual_seed(seed)
    lt = torch.from_numpy(l).expand(chunk, *l.shape[1:])
    return torch.cat([tdmll.sample(RGB, lt, 3, g) for _ in
                      range(n // chunk)]).numpy()


def jax_draws(l, n, seed=0, chunk=2000):
    spec = jdmll.DMLLSpec(rgb_scale=True)
    f = jax.jit(lambda key: jdmll.sample(
        spec, jnp.broadcast_to(jnp.asarray(l), (chunk,) + l.shape[1:]), 3,
        key))
    keys = jax.random.split(jax.random.PRNGKey(seed), n // chunk)
    return np.concatenate([np.asarray(f(k)) for k in keys])


def hist(v):
    """Per-pixel histograms over 0..255 of rounded draws v (n, P) -> (P,
    256), normalised."""
    r = np.clip(np.round(v), 0, 255).astype(np.int64)
    out = np.zeros((r.shape[1], 256))
    for p in range(r.shape[1]):
        out[p] = np.bincount(r[:, p], minlength=256)
    return out / r.shape[0]


def test_sample_shapes_and_range():
    l = mixture_l(0, 4, 6)
    g = torch.Generator().manual_seed(0)
    x = tdmll.sample(RGB, torch.from_numpy(l).expand(5, 4, 6, -1), 3, g)
    assert x.shape == (5, 4, 6, 3) and x.dtype == torch.float32
    assert float(x.min()) >= 0 and float(x.max()) <= 255
    # extreme means: the clamps hold every channel, after the chain too
    l2 = l.reshape(1, 4, 6, 4, 3, K).copy()
    l2[..., 1, :, :] = np.where(np.arange(K) % 2, 400.0, -300.0)
    x2 = tdmll.sample(RGB, torch.from_numpy(l2.reshape(l.shape)), 3, g)
    assert float(x2.min()) >= 0 and float(x2.max()) <= 255
    bn = tdmll.DMLLSpec(rgb_scale=False, x_min=-1.0, x_max=1.0, L=25)
    lb = mixture_l(1, 4, 6, C=5, rgb=False)
    xb = tdmll.sample(bn, torch.from_numpy(lb), 5, g)
    assert xb.shape == (1, 4, 6, 5)
    assert float(xb.abs().max()) < 1.0 + 12 * math.exp(-2)


def test_sample_distributions_match_the_mixture_and_jax():
    l = mixture_l(2)
    t = port_draws(l, N_DRAWS).reshape(N_DRAWS, 64, 3)
    j = jax_draws(l, N_DRAWS).reshape(N_DRAWS, 64, 3)
    # R: the exact distribution, exp(-nll) at every value of the channel
    vals = torch.arange(256, dtype=torch.float32)
    x = vals[:, None, None, None].expand(256, 8, 8, 3).contiguous()
    nll = tdmll.nll_plain(RGB, x, torch.from_numpy(l).expand(256, 8, 8, -1))
    p_r = torch.exp(-nll[..., 0]).reshape(256, 64).T.double().numpy()
    assert np.allclose(p_r.sum(1), 1, atol=1e-4)
    tv_r = 0.5 * np.abs(hist(t[..., 0]) - p_r).sum(1)
    # G, B: against JAX's draws (the chain runs on each package's R, G)
    tv_gb = [0.5 * np.abs(hist(t[..., c]) - hist(j[..., c])).sum(1)
             for c in (1, 2)]
    # (a pixel whose channel the clamp pins in both has no spread: its
    # means must be equal)
    z = [np.abs(t[..., c].mean(0) - j[..., c].mean(0)) / np.maximum(
        np.sqrt((t[..., c].var(0) + j[..., c].var(0)) / N_DRAWS), 1e-30)
        for c in range(3)]
    print(f"TV R vs exp(-nll) max {tv_r.max():.4f}, G/B vs JAX max "
          f"{tv_gb[0].max():.4f} / {tv_gb[1].max():.4f}; mean gaps in "
          f"pooled SEs max {[round(float(v.max()), 2) for v in z]}")
    assert tv_r.max() <= 0.03
    assert max(v.max() for v in tv_gb) <= 0.04
    assert max(v.max() for v in z) <= 5


def test_same_seed_same_draws():
    l = torch.from_numpy(mixture_l(3, 4, 4))
    a = tdmll.sample(RGB, l, 3, torch.Generator().manual_seed(7))
    b = tdmll.sample(RGB, l, 3, torch.Generator().manual_seed(7))
    c = tdmll.sample(RGB, l, 3, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------------- sample_forward

def _tiny(baseline=False):
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
    return jc, tc


def degenerate(params, cfg):
    """The classifiers' 1x1 projections zeroed, their biases: component 0
    logit 50 (others 0), means 60 + 20 c (RGB) or 0.2 c - 0.3 (bn),
    log-scales -9 (clamped to -7), lambda logits 0.4."""
    tree = jax.tree_util.tree_map(np.array, params)
    K = cfg.prob.K
    for name, clf in tree["params"].items():
        if not name.startswith("clf"):
            continue
        lin = clf["atrous"]["lin"]
        rgb = name == "clf0" or cfg.rgb_bicubic_baseline
        C = 3 if rgb else cfg.q.C
        b = np.zeros((4 if rgb else 3, C, K), np.float32)
        b[0, :, 0] = 50.0
        b[1] = (60.0 + 20.0 * np.arange(C) if rgb else
                0.2 * np.arange(C) - 0.3)[:, None]
        b[2] = -9.0
        if rgb:
            b[3] = 0.4
        lin["kernel"][:] = 0.0
        lin["bias"][:] = b.reshape(-1)
    return tree


@pytest.mark.parametrize("baseline", [False, True])
def test_sample_forward_degenerate_matches_jax(baseline):
    jc, tc = _tiny(baseline)
    jn = JNet(jc)
    params = degenerate(jax.jit(jn.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 3))), jc)
    tn = TNet(tc)
    tn.load_state_dict(params_from_jax(params), strict=True)
    tn.eval()
    img = np.random.RandomState(4).randint(0, 256, (1, 16, 24, 3)) \
        .astype(np.float32)
    d = math.exp(-7.0) * U_TAIL
    lam = 1 / (1 + math.exp(-0.4))
    tol = 2 * d * np.array([1, 1 + lam, 1 + lam + lam * (1 + lam)]) + 1e-4
    for scales in ((), (0,), (0, 1)):
        want = np.asarray(jax.jit(lambda p, x: jn.apply(
            p, x, jax.random.PRNGKey(0), scales,
            method=JNet.sample_forward))(params, jnp.asarray(img)))
        with torch.no_grad():
            got = tn.sample_forward(torch.from_numpy(img),
                                    torch.Generator().manual_seed(0),
                                    scales).numpy()
        assert got.shape == want.shape == img.shape
        gap = np.abs(got - want).reshape(-1, 3).max(0)
        assert (gap <= tol).all(), (scales, gap, tol)
        means = np.array([60.0, 80 + 60 * lam,
                          100 + 60 * lam + lam * (80 + 60 * lam)])
        assert np.abs(got - means).max() <= tol.max()


# --------------------------------------------------------- cli --sample

def test_cli_test_sample_writes_jax_names(tmp_path):
    """cli.test --sample OUT (tiny model, CPU): OUT holds
    <stem>_sample.png, _sample0.png and _sample0_1.png per image, the names
    JAX's tester writes, each the padded image's size; the table is
    printed as without --sample."""
    cfg_root = tmp_path / "configs"
    (cfg_root / "ms").mkdir(parents=True)
    (cfg_root / "dl").mkdir()
    (cfg_root / "ms" / "tiny.cf").write_text(
        "num_scales = 2\nCf = 8\nenc.num_blocks = 1\ndec.num_blocks = 1\n"
        "q.C = 2\nq.L = 25\nprob.K = 2\n")
    (cfg_root / "dl" / "tinydl.cf").write_text("crop_size = 16\n")
    log_dir = tmp_path / "logs" / "0707_0707 tiny tinydl"
    log_dir.mkdir(parents=True)
    jc, _ = _tiny()
    params = jax.jit(JNet(jc).init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 16, 16, 3)))
    Saver(str(log_dir)).save({"params": params, "opt_state": {},
                              "step": 3}, 3)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(5)
    write_png(str(imgs / "a.png"), rng.randint(0, 256, (15, 22, 3))
              .astype(np.uint8))
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    assert test_cli.main([str(tmp_path / "logs"), "0707", str(imgs),
                          "--sample", str(out_t), "--config_roots",
                          str(cfg_root), "--device", "cpu"]) == 0
    jt = JTester.from_log_dir(str(log_dir), [str(cfg_root)],
                              use_cache=False)
    from l3c_tpu.data.images import Testset as JSet
    jt.sample(JSet(str(imgs)), str(out_j))
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j)) == [
        "a_sample.png", "a_sample0.png", "a_sample0_1.png"]
    for n in names:
        got, want = read_png(str(out_t / n)), read_png(str(out_j / n))
        assert got.shape == want.shape == (16, 24, 3)
        assert got.dtype == np.uint8
