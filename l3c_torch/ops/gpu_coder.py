"""rANS entropy coding on the card: many independent streams per scale.

Port of `l3c_tpu/ops/tpu_coder.py`'s stream coder. Each channel's pixels
are split into streams of T symbols; every stream is coded independently
(rANS32: u32 state, 16-bit probabilities, 16-bit word renorm, at most one
word per symbol), so the work is sequential per stream and parallel
across streams. On the card one CUDA thread walks one stream
(kernels/csrc/rans.cu); on the CPU the plain versions below step all
streams together, one symbol per step. Both are integer-exact and give
the JAX scans' words, lengths and symbols bit for bit.

Stream layout (per-channel aligned): C channels of n symbols; channel c
owns stream rows [c*ns_c, (c+1)*ns_c); the last stream of each channel is
zero-padded to T and its padding slots are masked off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

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


def rans_encode(start: torch.Tensor, freq: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (NS, T) int32 (start, freq) pairs into rANS streams.

    mask (NS, T) bool: False slots are skipped (tail padding). Returns
    (words (NS, T+2) int32 holding u16 values in DECODE order
    [state_lo, state_hi, renorm words...], lengths (NS,) int32 in words).
    Slots past a stream's length are unspecified: the kernel leaves them
    unwritten, the plain version zero. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if start.is_cuda:
        return kernels.rans_encode(start.contiguous(), freq.contiguous(),
                                   mask.contiguous())
    return rans_encode_plain(start, freq, mask)


def rans_encode_plain(start, freq, mask):
    """The plain version: all streams in lockstep, T steps in reverse
    symbol order, u32 state carried in int64 and masked to 32 bits."""
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


def rans_decode(rows: torch.Tensor, words: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """Decode streams against per-position CDF rows.

    rows (L, NS, T) int32 lane-major CDF rows (u16 values); words (NS, W)
    int32 u16 words in decode order; mask (NS, T) bool. Returns syms
    (NS, T) int32. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if rows.is_cuda:
        return kernels.rans_decode(rows.contiguous(), words.contiguous(),
                                   mask.contiguous())
    return rans_decode_plain(rows, words, mask)


def rans_decode_plain(rows, words, mask):
    """The plain version: one symbol of every stream per step. Per symbol:
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


# --------------------------------------------------- channel-level API


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
    """rANS-encode precomputed (start, freq) pairs, channel-major (C*n,)
    or (C, n) -> (words (lanes, T+2), lengths (lanes,))."""
    mask = _mask_for(lay, start.device)
    return rans_encode(_to_streams(start, lay), _to_streams(freq, lay), mask)


def decode_channels(tables: torch.Tensor, words: torch.Tensor, L: int,
                    lay: StreamLayout) -> torch.Tensor:
    """tables (L, C*n) int32 LANE-MAJOR, words (lanes, W) -> syms (C, n)."""
    t = tables.reshape(L, lay.C, lay.n)
    t = torch.nn.functional.pad(t, (0, lay.pad))
    syms = rans_decode(t.reshape(L, lay.lanes, lay.T).contiguous(), words,
                       _mask_for(lay, tables.device))
    return _from_streams(syms, lay)


def encode_uniform(syms: torch.Tensor, L: int, lay: StreamLayout):
    """All channels under the uniform prior."""
    row = torch.from_numpy(uniform_cdf_row(L)).to(syms.device)
    start, freq = table_lookup_symbol(row[:, None], syms.reshape(-1), L)
    return encode_sf(start, freq, lay)


def decode_uniform(words: torch.Tensor, L: int, lay: StreamLayout
                   ) -> torch.Tensor:
    row = torch.from_numpy(uniform_cdf_row(L)).to(words.device)
    tables = row[:, None].expand(L, lay.C * lay.n)
    return decode_channels(tables, words, L, lay)
