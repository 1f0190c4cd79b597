"""AV1's range decoder (the symbol decoder of the AV1 specification,
section 8.2), as a tile of an AV1 frame is read by dav1d.

The state is the specification's SymbolValue / SymbolRange with the
bytes ahead held in one integer: `dif >> k` is SymbolValue, and `k` bits
of the (inverted) bitstream wait below it, so a renormalisation only
lowers `k`. CDFs are lists in the decoders' inverse form
(`32768 - cdf[i]`, the closing 0, then the adaptation counter), one list
a context, adapted in place unless the frame disables CDF updates.
"""
from __future__ import annotations

from typing import List


class SymbolReader:
    """init_symbol(sz) over `data[pos:end]`; read_symbol, read_bool,
    read_literal, NS; SymbolMaxBits, which exit_symbol bounds."""

    __slots__ = ("data", "pos", "end", "dif", "k", "rng", "update",
                 "size", "loaded")

    def __init__(self, data: bytes, pos: int, end: int,
                 disable_cdf_update: bool):
        self.data, self.pos, self.end = data, pos, end
        self.size = end - pos
        self.update = not disable_cdf_update
        self.dif, self.k, self.rng, self.loaded = 0, -15, 1 << 15, 0
        self._refill()

    def _refill(self):
        # 6 bytes at a time; past the end the data reads as zeros, which
        # the inversion turns into ones (the specification's padding)
        n = 6
        chunk = self.data[self.pos:min(self.pos + n, self.end)]
        self.pos += len(chunk)
        v = int.from_bytes(chunk, "big") ^ ((1 << (8 * len(chunk))) - 1)
        v = (v << (8 * (n - len(chunk)))) | ((1 << (8 * (n - len(chunk))))
                                             - 1)
        self.dif = (self.dif << (8 * n)) | v
        self.k += 8 * n
        self.loaded += 8 * n

    def symbol(self, cdf: List[int]) -> int:
        """read_symbol: the decoded value, `cdf` adapted."""
        n = len(cdf) - 1
        k = self.k
        val = self.dif >> k
        r8 = self.rng >> 8
        prev = cur = self.rng
        s = -1
        while True:
            s += 1
            prev = cur
            cur = ((r8 * (cdf[s] >> 6)) >> 1) + 4 * (n - s - 1)
            if val >= cur:
                break
        rng = prev - cur
        self.dif -= cur << k
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        self.k = k - bits
        if self.k < 16:
            self._refill()
        if self.update:
            cnt = cdf[n]
            rate = 3 + (cnt > 15) + (cnt > 31) + (2 if n > 3 else
                                                 (n >> 1))
            for i in range(n - 1):
                if i < s:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            if cnt < 32:
                cdf[n] = cnt + 1
        return s

    def bool(self) -> int:
        """read_bool: one bit at probability 1/2, no adaptation."""
        k = self.k
        cur = ((self.rng >> 8) << 7) + 4
        if (self.dif >> k) >= cur:
            rng, s = self.rng - cur, 0
            self.dif -= cur << k
        else:
            rng, s = cur, 1
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        self.k = k - bits
        if self.k < 16:
            self._refill()
        return s

    def max_bits(self) -> int:
        """The specification's SymbolMaxBits: the tile's bits not yet
        taken into the value (negative once it reads past its end)."""
        return 8 * self.size - (self.loaded - self.k)

    def literal(self, n: int) -> int:
        """read_literal(n): n bits, most significant first."""
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bool()
        return x

    def ns(self, n: int) -> int:
        """NS(n) read with literal bits (palette colour indices)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)

    def symbol_fixed(self, cdf: List[int]) -> int:
        """read_symbol of a CDF built on the fly (the partition's
        split_or_horz / split_or_vert), without adaptation."""
        update, self.update = self.update, False
        try:
            return self.symbol(cdf)
        finally:
            self.update = update


def cdf_copy(flat, nsyms):
    """Lists of inverse CDFs (with a zero counter) from a table's flat
    entries."""
    out, at = [], 0
    for n in ([nsyms] * (len(flat) // nsyms) if isinstance(nsyms, int)
              else nsyms):
        out.append(list(flat[at:at + n]) + [0])
        at += n
    return out
