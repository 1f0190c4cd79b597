"""The four CUDA kernels of l3c_torch against their plain PyTorch versions.

Needs an NVIDIA card (sm_90a) and nvcc; skips elsewhere. This file imports
no JAX, so on the card machine it runs without the JAX test setup:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py -q
"""
import numpy as np
import pytest
import torch

from l3c_torch.ops import float_cdf, gpu_coder, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, ns, T, L):
    """Strictly increasing +2l rows with row[0] = 0, lane-major (L,NS,T)."""
    c = np.sort(rng.randint(0, 65536 - 2 * L, (ns, T, L)), axis=-1)
    r = c + 2 * np.arange(L)
    r[..., 0] = 0
    return np.ascontiguousarray(r.transpose(2, 0, 1)).astype(np.int32)


def _sf(rows, syms, L):
    rl = torch.from_numpy(rows.reshape(L, -1))
    st, fr = gpu_coder.table_lookup_symbol(rl, torch.from_numpy(
        syms.reshape(-1)), L)
    ns, T = syms.shape
    return st.reshape(ns, T), fr.reshape(ns, T)


@pytest.mark.parametrize("L", [16, 25])
def test_rans_kernels_match_plain(cuda, L):
    rng = np.random.RandomState(L)
    ns, T = 200, 1024
    rows = _rows(rng, ns, T, L)
    syms = rng.randint(0, L, (ns, T))
    st, fr = _sf(rows, syms, L)
    mask = torch.ones((ns, T), dtype=torch.bool)
    mask[-1, -37:] = False
    w_ref, l_ref = gpu_coder.rans_encode_plain(st, fr, mask)
    w, l = gpu_coder.rans_encode(st.to(cuda), fr.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(l.cpu(), l_ref)
    # the kernel leaves slots past a stream's length unwritten
    used = torch.arange(T + 2)[None, :] < l_ref[:, None]
    assert torch.equal(w.cpu()[used], w_ref[used])
    s_ref = gpu_coder.rans_decode_plain(torch.from_numpy(rows), w_ref, mask)
    s = gpu_coder.rans_decode(torch.from_numpy(rows).to(cuda),
                              w[:, :int(l.max())], mask.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(s.cpu(), s_ref)
    assert torch.equal(s_ref[mask],
                       torch.from_numpy(syms)[mask].to(torch.int32))


def _mixture(rng, P, K):
    pi = rng.dirichlet(np.ones(K), size=P).astype(np.float32)
    mu = rng.uniform(-20, 280, (P, K)).astype(np.float32)
    inv_s = np.exp(-rng.uniform(-3, 4, (P, K))).astype(np.float32)
    return [torch.from_numpy(x) for x in (pi, mu, inv_s)]


def test_mixture_cdf_q_kernel_matches_plain(cuda):
    rng = np.random.RandomState(0)
    P, K, L = 5000, 10, 16
    pi, mu, inv_s = _mixture(rng, P, K)
    t = torch.arange(L, dtype=torch.float32) * 16.0 - 0.5
    ref = float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t, L)
    n0 = kernels.launches["mixture_cdf_q"]
    got = float_cdf.mixture_cdf_q(pi.to(cuda), mu.to(cuda), inv_s.to(cuda),
                                  t.to(cuda), L)
    torch.cuda.synchronize()
    assert kernels.launches["mixture_cdf_q"] == n0 + 1
    # sigmoid via expf vs torch.sigmoid: within one quantization step
    assert (got.cpu() - ref).abs().max().item() <= 1


def test_fine_cdf_q_kernel_matches_plain(cuda):
    rng = np.random.RandomState(1)
    P, K = 5000, 10
    pi, mu, inv_s = _mixture(rng, P, K)
    a = torch.from_numpy(np.clip(mu[:, 0].numpy() / 16.0, 0, 15)
                         .astype(np.int64)).to(torch.float32)
    ref = float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, 1.0, -0.5)
    got = float_cdf.fine_cdf_q(pi.to(cuda), mu.to(cuda), inv_s.to(cuda),
                               a.to(cuda), 1.0, -0.5).cpu()
    torch.cuda.synchronize()
    # well-conditioned rows only (the coarse bin holds real mass)
    t = (a[:, None] * 16.0 + torch.arange(17.0)) * 1.0 - 0.5
    cv = float_cdf.edge_cdf(pi, mu, inv_s, t)
    good = (cv[:, -1] - cv[:, 0]) > 1e-2
    assert good.sum() > P // 4
    assert (got[good] - ref[good]).abs().max().item() <= 2
    rows = float_cdf.finish_rows(got)
    d = torch.diff(torch.cat([rows, torch.full((P, 1), 65536)], 1), dim=1)
    assert (d >= 1).all()
