"""rANS entropy coding on the card: many independent streams per scale.

Port of `l3c_tpu/ops/tpu_coder.py`'s stream coder. Each channel's pixels
are split into streams of T symbols; every stream is coded independently
(rANS32: u32 state, 16-bit probabilities, 16-bit word renorm, at most one
word per symbol), so the work is sequential per stream and parallel
across streams.

The channel-level functions below (`encode_uniform`, `encode_bn`,
`encode_rgb`, `decode_uniform`, `decode_bn`, `decode_rgb_coarse`,
`decode_rgb_fine`) are what the codec calls. They take the per-scale
IntParams and the symbols: on the card one kernel launch each
(kernels/csrc/rans.cu) evaluates the exact-integer coding CDF inside the
rANS walk, as the JAX package's coder programs do; on the CPU the plain
version composes `int_coder`'s rows / 2-edge lookups with the plain scans
below, which step all streams together, one symbol per step. Both are
integer-exact and give the JAX coder's words, lengths and symbols bit for
bit.

Stream layout (per-channel aligned): C channels of n symbols; channel c
owns stream rows [c*ns_c, (c+1)*ns_c); the last stream of each channel is
zero-padded to T and its padding slots are masked off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import int_coder as ic
from . import kernels

# profile -> (max streams per channel, max T): `t_policy` picks the
# smallest power-of-two T in [1024, max_T] under the stream target. T is
# recorded per unit in the file, so any T decodes.
_PROFILES = {"speed": (1 << 30, 1024), "balanced": (64, 2048),
             "size": (8, 16384)}
DEFAULT_PROFILE = "balanced"

RANS_L = 1 << 16        # state lower bound
_MASK32 = (1 << 32) - 1


def t_policy(n: int, profile: Optional[str] = None) -> int:
    """Stream length for a unit of n symbols per channel."""
    nsc_max, t_max = _PROFILES[profile or DEFAULT_PROFILE]
    t = 1024
    while t < t_max and -(-n // t) > nsc_max:
        t *= 2
    return t


class StreamLayout(NamedTuple):
    """Stream geometry for C channels of n symbols each."""
    C: int
    n: int                # symbols per channel
    T: int

    @property
    def ns_c(self) -> int:
        return -(-self.n // self.T)

    @property
    def lanes(self) -> int:
        return self.C * self.ns_c

    @property
    def pad(self) -> int:
        return self.ns_c * self.T - self.n


def layout_for(n: int, C: int = 1, T: int = 1024) -> StreamLayout:
    return StreamLayout(C=C, n=n, T=T)


def _to_streams(flat_cn: torch.Tensor, lay: StreamLayout) -> torch.Tensor:
    """(C, n) or (C*n,) -> (lanes, T) with per-channel zero padding."""
    x = flat_cn.reshape(lay.C, lay.n)
    x = torch.nn.functional.pad(x, (0, lay.pad))
    return x.reshape(lay.lanes, lay.T)


def _from_streams(s: torch.Tensor, lay: StreamLayout) -> torch.Tensor:
    """(lanes, T) -> (C, n)."""
    return s.reshape(lay.C, lay.ns_c * lay.T)[:, : lay.n]


def _mask_for(lay: StreamLayout, device) -> torch.Tensor:
    """(lanes, T) bool: False on each channel's tail padding."""
    m = np.ones((lay.ns_c, lay.T), bool).reshape(-1)
    if lay.pad:
        m[-lay.pad:] = False
    m = np.broadcast_to(m.reshape(1, lay.ns_c, lay.T),
                        (lay.C, lay.ns_c, lay.T)).reshape(lay.lanes, lay.T)
    return torch.from_numpy(np.array(m)).to(device)


def uniform_cdf_row(L: int) -> np.ndarray:
    """Closed-form uniform table (coarsest scale)."""
    l = np.arange(L, dtype=np.uint64)
    return ((l << 16) // L).astype(np.int32)


# ------------------------------------------------------------ the scans


def rans_encode_plain(start, freq, mask):
    """Encode (NS, T) int32 (start, freq) pairs into rANS streams, all
    streams in lockstep, T steps in reverse symbol order, u32 state carried
    in int64 and masked to 32 bits.

    mask (NS, T) bool: False slots are skipped (tail padding). Returns
    (words (NS, T+2) int32 holding u16 values in DECODE order
    [state_lo, state_hi, renorm words...], zero past each length;
    lengths (NS,) int32 in words)."""
    ns, T = start.shape
    dev = start.device
    x = torch.full((ns,), RANS_L, dtype=torch.int64, device=dev)
    emits = torch.zeros((ns, T), dtype=torch.bool, device=dev)
    wds = torch.zeros((ns, T), dtype=torch.int64, device=dev)
    st_all = start.to(torch.int64)
    f_all = freq.to(torch.int64)
    for t in range(T - 1, -1, -1):
        m, f, st = mask[:, t], f_all[:, t], st_all[:, t]
        emit = m & (x >= ((f << 16) & _MASK32))
        emits[:, t] = emit
        wds[:, t] = x & 0xFFFF
        x1 = torch.where(emit, x >> 16, x)
        fs = torch.clamp(f, min=1)
        x2 = (((x1 // fs) << 16) + (x1 % fs) + st) & _MASK32
        x = torch.where(m, x2, x)
    n_emit = emits.sum(dim=1)
    # the word emitted j-th (chronologically, i.e. in reverse symbol
    # order) lands at decode position n_emit - 1 - j
    chrono = emits.flip(1)
    cum = torch.cumsum(chrono.to(torch.int64), dim=1)
    pos = n_emit[:, None] - cum                     # 0-based, where emitted
    words = torch.zeros((ns, T + 2), dtype=torch.int32, device=dev)
    rows = torch.arange(ns, device=dev)[:, None].expand(ns, T)
    words[rows[chrono], 2 + pos[chrono]] = wds.flip(1)[chrono].to(torch.int32)
    words[:, 0] = (x & 0xFFFF).to(torch.int32)
    words[:, 1] = (x >> 16).to(torch.int32)
    return words, (n_emit + 2).to(torch.int32)


def rans_decode_plain(rows, words, mask):
    """Decode streams against per-position CDF rows: rows (L, NS, T) int32
    lane-major (u16 values), words (NS, W) int32 u16 words in decode order,
    mask (NS, T) bool -> syms (NS, T) int32. One symbol of every stream
    per step. Per symbol:
    searchsorted of the row as counts/extrema (high = 65536 for the last
    symbol), the state update and a 16-bit renorm from the stream's own
    word cursor (words past W read as 0)."""
    L, ns, T = rows.shape
    W = words.shape[1]
    dev = rows.device
    wd = torch.cat([words.to(torch.int64),
                    torch.zeros((ns, 1), dtype=torch.int64, device=dev)], 1)
    x = wd[:, 0] | (wd[:, 1] << 16)
    cur = torch.full((ns,), 2, dtype=torch.int64, device=dev)
    lane = torch.arange(ns, device=dev)
    syms = torch.empty((ns, T), dtype=torch.int32, device=dev)
    top = 65536
    for t in range(T):
        row = rows[:, :, t].to(torch.int64)                 # (L, NS)
        cf = x & 0xFFFF
        le = row <= cf[None, :]
        s = torch.clamp(le.sum(dim=0) - 1, min=0)
        start = torch.where(le, row, 0).amax(dim=0)
        high = torch.clamp(torch.where(le, top, row).amin(dim=0), max=top)
        high = torch.where(s == L - 1, top, high)
        x1 = ((high - start) * (x >> 16) + (x & 0xFFFF) - start) & _MASK32
        need = x1 < RANS_L
        w = wd[lane, torch.clamp(cur, max=W)]
        x2 = torch.where(need, ((x1 << 16) | w) & _MASK32, x1)
        m = mask[:, t]
        x = torch.where(m, x2, x)
        cur = cur + (m & need).to(torch.int64)
        syms[:, t] = s.to(torch.int32)
    return syms


# ------------------------------------------- plain channel compositions


def table_lookup_symbol(rows: torch.Tensor, syms: torch.Tensor, L: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, freq) int32 for known symbols from lane-major rows (L, m)."""
    idx = torch.arange(L, device=rows.device)[:, None]
    le = idx <= syms[None, :]
    r = rows.to(torch.int64)
    start = torch.where(le, r, 0).amax(dim=0)
    high = torch.clamp(torch.where(le, 65536, r).amin(dim=0), max=65536)
    high = torch.where(syms == L - 1, 65536, high)
    return start.to(torch.int32), (high - start).to(torch.int32)


def encode_sf(start: torch.Tensor, freq: torch.Tensor, lay: StreamLayout):
    """Plain rANS encode of precomputed (start, freq) pairs, channel-major
    (C*n,) or (C, n) -> (words (lanes, T+2), lengths (lanes,))."""
    mask = _mask_for(lay, start.device)
    return rans_encode_plain(_to_streams(start, lay), _to_streams(freq, lay),
                             mask)


def decode_channels(tables: torch.Tensor, words: torch.Tensor, L: int,
                    lay: StreamLayout) -> torch.Tensor:
    """Plain decode against tables (L, C*n) int32 LANE-MAJOR rows, words
    (lanes, W) -> syms (C, n) u8."""
    t = tables.reshape(L, lay.C, lay.n)
    t = torch.nn.functional.pad(t, (0, lay.pad))
    syms = rans_decode_plain(t.reshape(L, lay.lanes, lay.T), words,
                             _mask_for(lay, tables.device))
    return _from_streams(syms, lay).to(torch.uint8)


def _uniform_row(L: int, device) -> torch.Tensor:
    return torch.from_numpy(uniform_cdf_row(L)).to(device)


def _chain_syms(dec: Optional[torch.Tensor], c: int):
    """The known channel symbols of the lambda chain as int_coder takes
    them: rows 0..c-1 of dec (3, N)."""
    return tuple(dec[j] for j in range(c)) if c else ()


# ---------------------------------------------------- channel-level API
#
# Each function dispatches on its tensors' device: a CUDA tensor launches
# the kernel (which raises if it cannot), a CPU tensor takes the plain
# version beside it (`*_plain`, any device). IntParams are lane-major
# (C, K', N) f32 with N = F n pixels per channel; symbol planes are (C, N).


def encode_uniform(syms: torch.Tensor, L: int, lay: StreamLayout):
    """All lay.C groups of n symbols ((C*n,) or (C, n)) under the uniform
    prior -> (words (lanes, T+2), lengths (lanes,))."""
    if syms.is_cuda:
        return kernels.rans_encode("uniform", _u8(syms.reshape(lay.C, lay.n)),
                                   lay.n, lay.T, L)
    return encode_uniform_plain(syms, L, lay)


def encode_uniform_plain(syms, L, lay):
    start, freq = table_lookup_symbol(_uniform_row(L, syms.device)[:, None],
                                      syms.reshape(-1), L)
    return encode_sf(start, freq, lay)


def decode_uniform(words: torch.Tensor, L: int, lay: StreamLayout
                   ) -> torch.Tensor:
    """-> syms (lay.C, n) u8 under the uniform prior."""
    if words.is_cuda:
        return kernels.rans_decode("uniform", words.contiguous(), lay.n,
                                   lay.T, L)
    return decode_uniform_plain(words, L, lay)


def decode_uniform_plain(words, L, lay):
    tables = _uniform_row(L, words.device)[:, None].expand(L, lay.C * lay.n)
    return decode_channels(tables, words, L, lay)


def encode_bn(ip: ic.IntParams, syms: torch.Tensor, L: int,
              lay: StreamLayout):
    """A bottleneck scale: syms (C, N) of C channels, lay.C = C*F groups of
    n pixels -> (words, lengths)."""
    if syms.is_cuda:
        return kernels.rans_encode("bn", _u8(syms), lay.n, lay.T, L,
                                   _contig(ip), lay.C // syms.shape[0])
    return encode_bn_plain(ip, syms, L, lay)


def encode_bn_plain(ip, syms, L, lay):
    start, freq = ic.bn_lookup(ip, syms, syms.shape[0], L)
    return encode_sf(start, freq, lay)


def decode_bn(ip: ic.IntParams, words: torch.Tensor, L: int,
              lay: StreamLayout) -> torch.Tensor:
    """A bottleneck scale of C = ip.p.shape[0] channels -> syms
    (lay.C = C*F, n) u8."""
    if words.is_cuda:
        return kernels.rans_decode("bn", words.contiguous(), lay.n, lay.T, L,
                                   _contig(ip), lay.C // ip.p.shape[0])
    return decode_bn_plain(ip, words, L, lay)


def decode_bn_plain(ip, words, L, lay):
    return decode_channels(ic.bn_rows(ip, ip.p.shape[0], L), words, L, lay)


def encode_rgb(ip: ic.IntParams, syms: torch.Tensor, lay6: StreamLayout):
    """Both scale-0 units in ONE launch over the stacked 6F groups: the
    coarse symbols of channels 0..2, then the fine ones (the streams are
    independent, so stacking only widens the launch). syms (3, N) are the
    image's channel planes; the lambda chain runs on them."""
    if syms.is_cuda:
        return kernels.rans_encode("rgb", _u8(syms), lay6.n, lay6.T,
                                   ic.N_COARSE, _contig(ip), lay6.C // 6)
    return encode_rgb_plain(ip, syms, lay6)


def encode_rgb_plain(ip, syms, lay6):
    t = syms.to(torch.int64)
    a, b = t >> 4, t & 15
    sc_, fc_, sf_, ff_ = [], [], [], []
    for c in range(3):
        dec = _chain_syms(t, c)
        s1, f1 = ic.rgb_coarse_lookup(ip, c, dec, a[c])
        s2, f2 = ic.rgb_fine_lookup(ip, c, dec, a[c], b[c])
        sc_.append(s1), fc_.append(f1), sf_.append(s2), ff_.append(f2)
    return encode_sf(torch.cat(sc_ + sf_), torch.cat(fc_ + ff_), lay6)


def decode_rgb_coarse(ip: ic.IntParams, c: int, dec: torch.Tensor,
                      words: torch.Tensor, lay: StreamLayout) -> torch.Tensor:
    """RGB channel c's coarse symbols (N,) u8; dec (3, N) u8 holds the
    decoded symbols of channels < c (the lambda chain); lay.C = F."""
    if words.is_cuda:
        return kernels.rans_decode("rgb_coarse", words.contiguous(), lay.n,
                                   lay.T, ic.N_COARSE, _contig(ip), lay.C,
                                   c, dec).reshape(-1)
    return decode_rgb_coarse_plain(ip, c, dec, words, lay)


def decode_rgb_coarse_plain(ip, c, dec, words, lay):
    rows = ic.rgb_coarse_rows(ip, c, _chain_syms(dec, c))
    return decode_channels(rows, words, ic.N_COARSE, lay).reshape(-1)


def decode_rgb_fine(ip: ic.IntParams, c: int, dec: torch.Tensor,
                    a_sym: torch.Tensor, words: torch.Tensor,
                    lay: StreamLayout) -> torch.Tensor:
    """RGB channel c's fine symbols (N,) u8, conditional on its coarse
    symbols a_sym (N,) u8."""
    if words.is_cuda:
        return kernels.rans_decode("rgb_fine", words.contiguous(), lay.n,
                                   lay.T, ic.FINE, _contig(ip), lay.C, c,
                                   dec, a_sym).reshape(-1)
    return decode_rgb_fine_plain(ip, c, dec, a_sym, words, lay)


def decode_rgb_fine_plain(ip, c, dec, a_sym, words, lay):
    rows = ic.rgb_fine_rows(ip, c, _chain_syms(dec, c), a_sym)
    return decode_channels(rows, words, ic.FINE, lay).reshape(-1)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8).contiguous()


def _contig(ip: ic.IntParams) -> ic.IntParams:
    return ic.IntParams(*[None if x is None else x.contiguous() for x in ip])
