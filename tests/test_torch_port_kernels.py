"""The CUDA kernels of l3c_torch against their plain PyTorch versions.

Needs an NVIDIA card (sm_90a) and nvcc; skips elsewhere. This file imports
no JAX, so on the card machine it runs without the JAX test setup:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py -q
"""
import numpy as np
import pytest
import torch

from l3c_torch.codec.bitcoding2 import pack_int
from l3c_torch.models import dmll
from l3c_torch.ops import float_cdf, gpu_coder, int_coder as ic, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _int_params(N, K, rgb, seed):
    """Random IntParams (C, K, N) within the evaluator's ranges, sharp and
    flat mixtures mixed (the construction of test_torch_port_int_coder)."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else 5
    pi = rng.dirichlet(np.ones(K) * rng.choice([0.05, 0.5]), (C, N))
    a_hat = np.clip(np.exp(rng.uniform(-6, 5, (C, N, K))), 1 / 256, 64)
    m_hat = rng.uniform(-10, 300 if rgb else 30, (C, N, K))
    v = np.clip(np.round(m_hat * a_hat * 1024), -2 ** 24, 2 ** 24)
    w = (np.round(rng.uniform(0, 1, (3, N, K)) * a_hat[[1, 2, 2]] * 1024)
         if rgb else None)
    fields = (np.round(pi * 4096), np.round(a_hat * 1024),
              np.round(a_hat * 16 * 1024), v, w)
    return ic.IntParams(*[
        None if x is None else torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 1)).astype(np.float32)) for x in fields])


def _on(ip, dev):
    return ic.IntParams(*[None if x is None else x.to(dev) for x in ip])


def _used(words, lengths):
    keep = (torch.arange(words.shape[1], device=words.device)[None, :]
            < lengths[:, None])
    return words[keep]


# (n, T) with n not a multiple of T and several streams per group; F = 2
@pytest.mark.parametrize("mode,K", [("uniform", 4), ("bn", 4), ("bn", 10),
                                    ("rgb", 4), ("rgb", 10)])
def test_rans_kernels_match_plain(cuda, mode, K):
    """K3 and K4 in every mode against their plain versions: lengths and
    used words identical, decoded symbols identical and equal to the
    encoded ones."""
    _rans_on_card(cuda, mode, K, 25)


# beyond the tiles (the generic variants): K' = 12, 16, 32 and 255 (the
# cap) components, L = 40 and 256 (the cap; the baselines' unit 0 is
# uniform there) symbols
@pytest.mark.parametrize("mode,K,L", [("bn", 12, 25), ("bn", 16, 40),
                                      ("uniform", 4, 40), ("bn", 4, 40),
                                      ("rgb", 12, 16), ("rgb", 16, 16),
                                      ("uniform", 4, 256), ("bn", 4, 256),
                                      ("bn", 255, 25), ("rgb", 32, 16),
                                      ("rgb", 255, 16)])
def test_rans_kernels_beyond_the_tiles(cuda, mode, K, L):
    _rans_on_card(cuda, mode, K, L)


def _rans_on_card(cuda, mode, K, L):
    F, n, T = 2, 3000, 1024
    N = F * n
    rng = np.random.RandomState(K)
    n0 = dict(kernels.launches)
    if mode == "rgb":
        ip = _int_params(N, K, True, K)
        syms = torch.from_numpy(rng.randint(0, 256, (3, N)))
        lay = gpu_coder.layout_for(n, 6 * F, T)
        enc = lambda s, p: gpu_coder.encode_rgb(p, s, lay)
    else:
        ip = _int_params(N, K, False, K)
        syms = torch.from_numpy(rng.randint(0, L, (5, N)))
        lay = gpu_coder.layout_for(n, 5 * F, T)
        enc = ((lambda s, p: gpu_coder.encode_uniform(s, L, lay))
               if mode == "uniform" else
               (lambda s, p: gpu_coder.encode_bn(p, s, L, lay)))
    ipc = _on(ip, cuda)
    w_ref, l_ref = enc(syms, ip)
    w, l = enc(syms.to(cuda), ipc)
    torch.cuda.synchronize()
    assert torch.equal(l.cpu(), l_ref)
    assert torch.equal(_used(w.cpu(), l.cpu()), _used(w_ref, l_ref))
    if mode == "rgb":
        half = lay.lanes // 2
        lay1 = gpu_coder.layout_for(n, F, T)
        ns = F * lay1.ns_c
        dec = {d: torch.zeros((3, N), dtype=torch.uint8, device=d)
               for d in ("cpu", cuda)}
        for c in range(3):
            wc = w_ref[c * ns:(c + 1) * ns]
            wf = w_ref[half + c * ns:half + (c + 1) * ns]
            got = {}
            for d, p in (("cpu", ip), (cuda, ipc)):
                a = gpu_coder.decode_rgb_coarse(p, c, dec[d], wc.to(d), lay1)
                b = gpu_coder.decode_rgb_fine(p, c, dec[d], a, wf.to(d),
                                              lay1)
                got[d] = (a.cpu(), b.cpu())
                dec[d][c] = (a << 4) | b
            assert torch.equal(got["cpu"][0], got[cuda][0])
            assert torch.equal(got["cpu"][1], got[cuda][1])
        assert torch.equal(dec[cuda].cpu().long(), syms)
        assert torch.equal(dec["cpu"].long(), syms)
    else:
        dec_fn = ((lambda w_, p: gpu_coder.decode_uniform(w_, L, lay))
                  if mode == "uniform" else
                  (lambda w_, p: gpu_coder.decode_bn(p, w_, L, lay)))
        ref = dec_fn(w_ref, ip)
        got = dec_fn(w_ref.to(cuda), ipc)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref)
        assert torch.equal(ref.reshape(5, N).long(), syms)
    want = {"rans_encode": 1, "rans_decode": 6 if mode == "rgb" else 1}
    assert {k: kernels.launches[k] - n0.get(k, 0) for k in want} == want


def test_canary_holds_the_kernels_on_card(cuda):
    """The card's canary packs with K5 and first holds K3/K4 to int_coder
    on its IntParams at every symbol value (coder_check), which raises if
    they differ."""
    from l3c_torch import blueprint, config
    from l3c_torch.codec.bitcoding2 import contract_canary
    cfg = config.MsConfig()
    n0 = dict(kernels.launches)
    contract_canary(blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg),
                    cfg.q.C, cfg.prob.K, 4, cuda)
    want = {"rans_encode": 2, "rans_decode": 7, "pack_int": 2}
    assert {k: kernels.launches[k] - n0.get(k, 0) for k in want} == want


@pytest.mark.parametrize("rgb,K,topk", [(True, 10, 4), (True, 10, 0),
                                        (False, 10, 4), (False, 10, 0),
                                        (False, 3, 2), (True, 12, 4),
                                        (False, 16, 0), (False, 16, 4)])
def test_pack_int_kernel_matches_plain(cuda, rgb, K, topk):
    """K5 against the plain version on the card, pi-logit ties and
    log-scales below the -7 clamp included: every output within one step,
    in at most 1e-3 of the entries (expf and the order of the softmax's
    sum are the kernel's own); the selected components exactly, shown by
    v of parameters that make it the component's index."""
    spec = dmll.DMLLSpec(True) if rgb else dmll.DMLLSpec(False, -1.0, 1.0,
                                                          25)
    C, P = (3, 4) if rgb else (5, 3)
    rng = np.random.RandomState(K + topk)
    N, H, W = 2, 37, 53
    l = (rng.randn(N, P, C, K, H, W) * 2.0).astype(np.float32)
    ties = rng.rand(N, 1, C, 1, H, W) < 0.2
    l[:, 0:1] = np.where(ties, np.round(l[:, 0:1]), l[:, 0:1])
    sharp = rng.rand(N, 1, C, K, H, W) < 0.2
    l[:, 2:3] = np.where(sharp, l[:, 2:3] * 4 - 9, l[:, 2:3])
    index = l.copy()                 # mu = k, log_s = 0: v tells k apart
    index[:, 1] = np.arange(K, dtype=np.float32)[None, None, :, None, None]
    index[:, 2] = 0.0
    n0 = kernels.launches["pack_int"]
    for x, exact in ((l, False), (index, True)):
        lc = torch.from_numpy(x.reshape(N, P * C * K, H, W)).to(cuda)
        got = pack_int(spec, lc, C, topk)
        want = ic.pack_int_params_nchw(spec, lc, C, topk)
        torch.cuda.synchronize()
        n_bad = n_all = 0
        for f, g, w in zip(got._fields, got, want):
            if w is None:
                assert g is None
                continue
            assert g.shape == w.shape and g.dtype == w.dtype
            d = (g - w).abs()
            assert float(d.max()) <= 1, f
            if exact and f == "v":
                assert float(d.max()) == 0
            n_bad += int((d > 0).sum())
            n_all += d.numel()
        assert n_bad <= 1e-3 * n_all
    assert kernels.launches["pack_int"] == n0 + 2


def _mixture(rng, P, K):
    pi = rng.dirichlet(np.ones(K), size=P).astype(np.float32)
    mu = rng.uniform(-20, 280, (P, K)).astype(np.float32)
    inv_s = np.exp(-rng.uniform(-3, 4, (P, K))).astype(np.float32)
    return [torch.from_numpy(x) for x in (pi, mu, inv_s)]


# sizes around the kernels' tiles (64 pixels in K1, 128 in K2): several
# tiles and a ragged last one, less than a tile, one pixel
@pytest.mark.parametrize("P,K,L", [(5000, 10, 16), (50, 10, 16), (1, 10, 16),
                                   (5000, 3, 25), (257, 4, 16),
                                   (5000, 12, 16), (5000, 16, 40),
                                   (257, 10, 40)])
def test_mixture_cdf_q_kernel_matches_plain(cuda, P, K, L):
    rng = np.random.RandomState(0)
    pi, mu, inv_s = _mixture(rng, P, K)
    t = torch.arange(L, dtype=torch.float32) * (256.0 / L) - 0.5
    ref = float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t, L)
    n0 = kernels.launches["mixture_cdf_q"]
    got = kernels.mixture_cdf_q(pi.to(cuda), mu.to(cuda), inv_s.to(cuda),
                                t.to(cuda), L).cpu()
    torch.cuda.synchronize()
    assert kernels.launches["mixture_cdf_q"] == n0 + 1
    # the card's approximate sigmoid against torch.sigmoid on the CPU:
    # within one quantization step
    assert (got - ref).abs().max().item() <= 1
    rows = float_cdf.finish_rows(got)
    d = torch.diff(torch.cat([rows, torch.full((P, 1), 65536)], 1), dim=1)
    assert (d >= 1).all()
    # the dispatching wrapper launches the kernel, and never the plain
    # version for a CUDA tensor
    again = float_cdf.mixture_cdf_q(pi.to(cuda), mu.to(cuda), inv_s.to(cuda),
                                    t.to(cuda), L)
    assert kernels.launches["mixture_cdf_q"] == n0 + 2
    assert torch.equal(again.cpu(), got)


@pytest.mark.parametrize("P,K", [(5000, 10), (50, 10), (1, 10), (129, 10),
                                 (5000, 12), (129, 16)])
def test_fine_cdf_q_kernel_matches_plain(cuda, P, K):
    rng = np.random.RandomState(1)
    pi, mu, inv_s = _mixture(rng, P, K)
    a = torch.from_numpy(np.clip(mu[:, 0].numpy() / 16.0, 0, 15)
                         .astype(np.int64)).to(torch.float32)
    ref = float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, 1.0, -0.5)
    n0 = kernels.launches["fine_cdf_q"]
    got = kernels.fine_cdf_q(pi.to(cuda), mu.to(cuda), inv_s.to(cuda),
                             a.to(cuda), 1.0, -0.5).cpu()
    torch.cuda.synchronize()
    assert kernels.launches["fine_cdf_q"] == n0 + 1
    # well-conditioned rows only (the coarse bin holds real mass)
    t = (a[:, None] * 16.0 + torch.arange(17.0)) * 1.0 - 0.5
    cv = float_cdf.edge_cdf(pi, mu, inv_s, t)
    good = (cv[:, -1] - cv[:, 0]) > 1e-2
    if P >= 50:
        assert good.sum() > P // 4
    if good.any():
        assert (got[good] - ref[good]).abs().max().item() <= 2
    rows = float_cdf.finish_rows(got)
    d = torch.diff(torch.cat([rows, torch.full((P, 1), 65536)], 1), dim=1)
    assert (d >= 1).all()


def test_float_cdf_kernels_refuse_what_they_do_not_take(cuda):
    """No component or no edge raises for a CUDA tensor; nothing is
    launched and no plain version runs in the kernel's place (K > 10 and
    L > 32 run the generic variants: the tests above)."""
    f = torch.zeros((4, 0), device=cuda)
    g = torch.zeros((4, 10), device=cuda)
    n0 = dict(kernels.launches)
    with pytest.raises(ValueError, match="K=0"):
        float_cdf.mixture_cdf_q(f, f, f, torch.zeros(16, device=cuda), 16)
    with pytest.raises(ValueError, match="K=0"):
        float_cdf.fine_cdf_q(f, f, f, torch.zeros(4, device=cuda), 1.0, -0.5)
    with pytest.raises(ValueError, match="L=0"):
        float_cdf.mixture_cdf_q(g, g, g, torch.zeros(0, device=cuda), 0)
    assert dict(kernels.launches) == n0


def dmll_inputs(rgb, K, seed, N=2, H=7, W=9, C=5):
    """(x (N,H,W,C), l (N,H,W,Kp)) made with numpy for K6: x on the spec's
    grid with both tails well represented (RGB 0 and 255, bottleneck -1
    and 1) plus, for the bottleneck, the straight-through estimator's
    rounding (a few ulps off the level); log-scales far below the -7 clamp
    in a fifth of the terms and exactly at it in some; lambda logits on
    the RGB scale."""
    rng = np.random.RandomState(seed)
    C = 3 if rgb else C
    P = 4 if rgb else 3
    l = rng.randn(N, H, W, P, C, K).astype(np.float32) * 2.0
    l[..., 1, :, :] *= 40.0 if rgb else 0.4
    if rgb:
        l[..., 1, :, :] += 128.0
    sharp = rng.rand(N, H, W, C, K) < 0.2
    l[..., 2, :, :] = np.where(sharp, l[..., 2, :, :] * 3 - 9,
                               l[..., 2, :, :])
    l[..., 2, :, :][rng.rand(N, H, W, C, K) < 0.05] = -7.0
    if rgb:
        x = rng.randint(0, 256, (N, H, W, C)).astype(np.float32)
        x[rng.rand(N, H, W, C) < 0.15] = 0.0
        x[rng.rand(N, H, W, C) < 0.15] = 255.0
    else:
        lv = np.linspace(-1.0, 1.0, 25).astype(np.float32)
        x = lv[rng.randint(0, 25, (N, H, W, C))]
        x[rng.rand(N, H, W, C) < 0.15] = -1.0
        x[rng.rand(N, H, W, C) < 0.15] = 1.0
        x = x + (rng.randint(-2, 3, x.shape) * 6e-8).astype(np.float32)
    return (torch.from_numpy(x),
            torch.from_numpy(l.reshape(N, H, W, P * C * K)))


def _nll64(spec, x, l, jiggle):
    """nll_plain's expression in float64, each result of a library call
    (exp, the sigmoids and their derivatives, log1p, log) and each
    lambda-conditioned mean passed through jiggle."""

    def sigmoid(z):
        y = torch.sigmoid(z)
        dy = jiggle(y * (1 - y))
        return jiggle(y).detach() + (z - z.detach()) * dy.detach()

    C = x.shape[-1]
    lr = l.reshape(*l.shape[:-1], spec.num_params, C, -1)
    logit, mean = lr[..., 0, :, :], lr[..., 1, :, :]
    ls = torch.maximum(lr[..., 2, :, :], torch.tensor(dmll.LOG_SCALES_MIN,
                                                      dtype=l.dtype))
    xk = x.unsqueeze(-1)
    if spec.rgb_scale:
        lam = sigmoid(lr[..., 3, :, :])
        mean = torch.stack([
            mean[..., 0, :],
            jiggle(mean[..., 1, :] + lam[..., 0, :] * xk[..., 0, :]),
            jiggle(mean[..., 2, :] + lam[..., 1, :] * xk[..., 0, :]
                   + lam[..., 2, :] * xk[..., 1, :])], dim=-2)
    inv = jiggle(torch.exp(-ls))
    p = inv * ((xk - mean) + spec.bin_width / 2)
    m = inv * ((xk - mean) - spec.bin_width / 2)

    def softplus(z):
        return z.clamp(min=0) + jiggle(torch.log1p(torch.exp(-z.abs())))

    delta = sigmoid(p) - sigmoid(m)
    lp = jiggle(torch.log(torch.maximum(delta, torch.tensor(
        1e-12, dtype=l.dtype))))
    lp = torch.where(xk > spec.x_upper_bound, -softplus(m), lp)
    lp = torch.where(xk < spec.x_lower_bound, p - softplus(p), lp)
    return -torch.logsumexp(lp + torch.log_softmax(logit, dim=-1), dim=-1)


def float32_spread(spec, x, l, g, rel=2.0 ** -23):
    """How far two float32 evaluations of nll's expression (K6, the plain
    version, JAX) may differ, per entry of (nll, grad_l, grad_x): the
    largest move of the float64 result and its gradient, over eight
    draws, when each result of a library call and each lambda-conditioned
    mean is off by `rel` either way (random signs). The default, two
    roundings, is for two evaluations on the CPU: the libraries' exp /
    log1p / log differ by an ulp here and there, and XLA may fuse the
    mean's products. Where a term's two sigmoids nearly cancel (one ulp
    of a sigmoid moves log(delta) by ~6e-8 / delta) or a narrow logistic
    sits on a large mean (one ulp of the mean, times exp(7)), the move
    exceeds the tight bound."""
    x, l, g = (t.detach().cpu().double() for t in (x, l, g))
    gen = torch.Generator().manual_seed(0)

    def grads(eps):
        def jiggle(v):
            s = torch.randint(0, 2, v.shape, generator=gen).to(v.dtype)
            return v * (1 + eps * (2 * s - 1))
        return dmll_grads(lambda *a: _nll64(*a, jiggle), spec, x, l, g)

    base = grads(0.0)
    spread = [torch.zeros_like(b) for b in base]
    for _ in range(8):
        for s, a, b in zip(spread, grads(rel), base):
            torch.maximum(s, (a - b).abs(), out=s)
    return spread


def assert_nll_close(got, want, spread=0.0):
    """Every element within 1e-5 relative + 1e-6 of the reference plus its
    float32_spread (0 where the element is well conditioned, or where both
    sides evaluate the same float32 operations); the sum within 1e-6
    relative."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    tight = 1e-5 * want.abs() + 1e-6
    n_out = int((err > tight).sum())
    worst = float((err / (tight + spread)).max())
    print(f"nll: {n_out}/{err.numel()} elements beyond 1e-5 rel + 1e-6 "
          f"(max abs {float(err.max()):.2e}), max diff / (that + spread) "
          f"{worst:.3f}")
    assert worst <= 1.0
    assert abs(float(got.sum() - want.sum())) <= 1e-6 * abs(float(
        want.sum()))


def assert_grad_close(name, got, want, spread=0.0):
    """Every entry within 1e-5 of the reference gradient's largest
    magnitude plus its float32_spread (the gradient of an ill-conditioned
    term carries 1 / delta)."""
    err = (got.double().cpu() - want.double().cpu()).abs()
    tight = 1e-5 * float(want.abs().max())
    n_out = int((err > tight).sum())
    worst = float((err / (tight + spread)).max())
    print(f"{name}: {n_out}/{err.numel()} entries beyond 1e-5 of max |grad| "
          f"(max abs {float(err.max()):.2e} of {tight * 1e5:.3e}), max diff "
          f"/ (that + spread) {worst:.3f}")
    assert worst <= 1.0, name


def dmll_grads(fn, spec, x, l, g):
    """(nll, grad_l, grad_x) of fn(spec, x, l) against upstream g."""
    x = x.clone().requires_grad_(True)
    l = l.clone().requires_grad_(True)
    out = fn(spec, x, l)
    (out * g).sum().backward()
    return out.detach(), l.grad, x.grad


def _dmll_on_card(cuda, rgb, K, C, N, H, W, seed):
    """K6 forward and backward on the card against the plain version and
    its autograd gradient: on the card, which runs the same float32
    operations through the same libraries, every element within the tight
    bound; on the CPU within the tight bound plus the float32 spread of
    four roundings (CUDA's expf is within 2 ulp, the CPU's within 1, and
    each sigmoid adds a sum and a division). One launch each."""
    spec = dmll.DMLLSpec(True) if rgb else dmll.DMLLSpec(False, -1.0, 1.0,
                                                          25)
    x, l = dmll_inputs(rgb, K, seed, N=N, H=H, W=W, C=C)
    g = torch.from_numpy(np.random.RandomState(1).rand(*x.shape)
                         .astype(np.float32))
    n0 = dict(kernels.launches)
    got = dmll_grads(dmll.nll, spec, x.to(cuda), l.to(cuda), g.to(cuda))
    torch.cuda.synchronize()
    assert {k: kernels.launches[k] - n0.get(k, 0)
            for k in ("dmll_nll", "dmll_nll_grad")} == {
        "dmll_nll": 1, "dmll_nll_grad": 1}
    card = dmll_grads(dmll.nll_plain, spec, x.to(cuda), l.to(cuda),
                      g.to(cuda))
    cpu = dmll_grads(dmll.nll_plain, spec, x, l, g)
    for want, spread in ((card, (0.0,) * 3),
                         (cpu, float32_spread(spec, x, l, g,
                                              rel=2.0 ** -21))):
        assert_nll_close(got[0], want[0], spread[0])
        assert_grad_close("grad_l", got[1], want[1], spread[1])
        assert_grad_close("grad_x", got[2], want[2], spread[2])


# W = 53 with seed K + C: the first cases; then the shapes of
# test_torch_port_dmll_host.py's ragged tiles (K6's tile is 32 pixels of
# one image): one pixel; several images with HW no multiple of the tile
# nor of 4; HW a multiple of 4 with ragged and whole tiles; K = 3 and 10,
# C = 3 with lambda and C = 5
@pytest.mark.parametrize("rgb,K,C,N,H,W,seed", [
    (True, 10, 3, 2, 37, 53, 13), (False, 10, 5, 2, 37, 53, 15),
    (True, 2, 3, 1, 5, 53, 5), (False, 3, 2, 1, 5, 53, 5),
    (True, 10, 3, 1, 1, 1, 11), (False, 10, 5, 3, 5, 7, 115),
    (True, 3, 3, 3, 5, 7, 108), (False, 3, 5, 2, 4, 13, 107),
    (True, 10, 3, 2, 4, 13, 114), (False, 10, 5, 2, 16, 12, 394),
    (True, 10, 3, 1, 8, 16, 138), (False, 10, 9, 2, 5, 7, 9),
    (False, 3, 16, 1, 8, 9, 16), (True, 12, 3, 2, 5, 7, 12),
    (False, 16, 5, 1, 4, 13, 21), (False, 16, 9, 1, 3, 5, 25)])
def test_dmll_kernel_matches_plain(cuda, rgb, K, C, N, H, W, seed):
    """K6 against the plain version on the card and on the CPU
    (_dmll_on_card's bounds)."""
    _dmll_on_card(cuda, rgb, K, C, N, H, W, seed)
