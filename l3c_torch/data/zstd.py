"""Zstandard frames decoded as RFC 8878 describes them, for TIFF's ZSTD
compression (50000), whose strips libtiff hands to libzstd.

`decompress(data)` gives the concatenated content of every frame in
`data`, skippable frames passed over; `decompress(data, limit)` reads as
libtiff's ZSTDDecode does, up to `limit` bytes of the first frame. A
frame's blocks are raw, RLE or compressed (a literals section, raw, RLE
or Huffman-coded in one or four streams, with the previous block's tree
for treeless ones, and a sequences section whose literal-length, offset and match-length codes
are FSE-coded with the predefined, RLE, described or repeated tables,
executed with the three repeat offsets); the content checksum (the low
32 bits of XXH64) is verified where the frame carries one, and a frame
that needs a dictionary, or a block whose content is above the largest
block size (as libzstd's stream decoder, libtiff's, refuses it), is
refused. Every fault raises ValueError.

The bit readers read whole streams into Python ints a window at a time;
the Huffman and sequence loops are plain Python (about a microsecond a
literal on a server core), a rate ROADMAP's J1 records.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

_MAGIC = 0xFD2FB528
_M64 = (1 << 64) - 1

# RFC 8878 3.1.1.3.2.2: literal-length and match-length codes -> (base,
# extra bits); offset codes are (1 << code) + `code` extra bits
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# RFC 8878 3.1.1.3.2.2: the predefined distributions and accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# the largest accuracy log and symbol of each table
_LL_MAX, _OF_MAX, _ML_MAX = (9, 35), (8, 31), (9, 52)


def _bad(what: str) -> ValueError:
    return ValueError(f"corrupt Zstandard data: {what}")


# ------------------------------------------------------------- bit readers

class _Forward:
    """Little-endian bits, least significant first (FSE table headers)."""

    def __init__(self, data: bytes, at: int):
        self.data, self.bit = data, at * 8

    def read(self, n: int) -> int:
        i, s = self.bit >> 3, self.bit & 7
        v = int.from_bytes(self.data[i:i + 4], "little") >> s
        self.bit += n
        if self.bit > len(self.data) * 8:
            raise _bad("a table description runs past its section")
        return v & ((1 << n) - 1)

    def end(self) -> int:
        """The byte after the bits read, rounded up."""
        return (self.bit + 7) >> 3


class _Backward:
    """A stream read from its last bit down, after the marker 1-bit that
    ends it; bits past its start read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _bad("a bit stream without its end marker")
        self.value = int.from_bytes(data, "little")
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        self.pos -= n
        if self.pos >= 0:
            return (self.value >> self.pos) & ((1 << n) - 1)
        return (self.value << -self.pos) & ((1 << n) - 1)


def _reader(data: bytes):
    """A backward stream read through a 64-bit window, for the hot loops:
    read(k) gives its next k bits (k <= 56; zeros past its start), used()
    how many were read and the stream holds."""
    if not data or data[-1] == 0:
        raise _bad("a bit stream without its end marker")
    skip = 9 - data[-1].bit_length()           # zeros and the marker
    rev = data[::-1]
    acc, nacc, i, used = rev[0] & (0xFF >> skip), 8 - skip, 1, 0

    def read(k: int) -> int:
        nonlocal acc, nacc, i, used
        if nacc < k:
            acc = ((acc & ((1 << nacc) - 1)) << 56) | int.from_bytes(
                rev[i:i + 7].ljust(7, b"\0"), "big")
            i += 7
            nacc += 56
        nacc -= k
        used += k
        return (acc >> nacc) & ((1 << k) - 1)

    return read, lambda: (used, len(data) * 8 - skip)


# ------------------------------------------------------------------ FSE

def _fse_description(data: bytes, at: int, max_log: int, max_sym: int
                     ) -> Tuple[List[int], int, int]:
    """RFC 8878 4.1.1: (probabilities, accuracy log, the byte after it)."""
    r = _Forward(data, at)
    log = r.read(4) + 5
    if log > max_log:
        raise _bad(f"FSE accuracy log {log} above {max_log}")
    remaining = 1 << log
    probs: List[int] = []
    while remaining > 0 and len(probs) <= max_sym:
        bits = (remaining + 1).bit_length()
        low = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)
        v = r.read(bits)
        if (v & low) < threshold:
            r.bit -= 1
            v &= low
        elif v > low:
            v -= threshold
        p = v - 1
        remaining -= -p if p < 0 else p
        probs.append(p)
        if p == 0:
            while True:
                rep = r.read(2)
                probs += [0] * rep
                if rep != 3:
                    break
    if remaining != 0 or len(probs) > max_sym + 1:
        raise _bad("FSE probabilities that do not add up")
    return probs, log, r.end()


def _fse_table(probs: List[int], log: int) -> List[Tuple[int, int, int]]:
    """RFC 8878 4.1.1's decoding table: state -> (symbol, bits, base)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _bad("an FSE table that does not spread")
    nxt = [1 if p == -1 else p for p in probs]
    table = []
    for state in range(size):
        s = sym[state]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        table.append((s, nb, (x << nb) - size))
    return table


def _rle_table(symbol: int) -> List[Tuple[int, int, int]]:
    return [(symbol, 0, 0)]


# ---------------------------------------------------------------- Huffman

def _huffman_weights(data: bytes, at: int) -> Tuple[List[int], int]:
    """RFC 8878 4.2.1: the weights of a tree description, the last one
    deduced, and the byte after it."""
    head = data[at]
    at += 1
    if head >= 128:
        n = head - 127
        raw = data[at:at + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _bad("a truncated Huffman tree")
        w = []
        for b in raw:
            w += [b >> 4, b & 15]
        w, end = w[:n], at + (n + 1) // 2
    else:
        end = at + head
        if end > len(data) or head == 0:
            raise _bad("a truncated Huffman tree")
        probs, log, start = _fse_description(data[:end], at, 6, 255)
        table = _fse_table(probs, log)
        r = _Backward(data[start:end])
        s1, s2 = r.read(log), r.read(log)
        w = []
        while True:            # two states in turn until the bits run out
            sym, nb, base = table[s1]
            w.append(sym)
            s1 = base + r.read(nb)
            if r.pos < 0:
                w.append(table[s2][0])
                break
            sym, nb, base = table[s2]
            w.append(sym)
            s2 = base + r.read(nb)
            if r.pos < 0:
                w.append(table[s1][0])
                break
            if len(w) > 255:
                raise _bad("too many Huffman weights")
    total = sum(1 << (x - 1) for x in w if x)
    if not total or any(x > 11 for x in w):
        raise _bad("Huffman weights out of range")
    bits = total.bit_length()
    rest = (1 << bits) - total
    if rest & (rest - 1):
        raise _bad("Huffman weights that leave no power of two")
    w.append(rest.bit_length())
    return w, end


def _huffman_table(weights: List[int]) -> Tuple[List[int], List[int], int]:
    """The decoding table (zstd's HUF_readDTableX1): max_bits-bit peeks
    -> symbol and code length, symbols by ascending weight, then value."""
    total = sum(1 << (w - 1) for w in weights if w)
    max_bits = total.bit_length() - 1
    if max_bits > 11:
        raise _bad("a Huffman code longer than 11 bits")
    size = 1 << max_bits
    start, at = {}, 0
    for w in range(1, max_bits + 2):
        start[w] = at
        at += sum(1 for x in weights if x == w) << (w - 1)
    syms, lens = [0] * size, [0] * size
    for s, w in enumerate(weights):
        if not w:
            continue
        n = 1 << (w - 1)
        a = start[w]
        syms[a:a + n] = [s] * n
        lens[a:a + n] = [max_bits + 1 - w] * n
        start[w] = a + n
    return syms, lens, max_bits


def _huffman_stream(data: bytes, n: int, table) -> bytes:
    """n literals of one backward Huffman stream, which they must use up
    exactly (libzstd's check)."""
    syms, lens, mb = table
    if not data or data[-1] == 0:
        raise _bad("a Huffman stream without its end marker")
    skip = 9 - data[-1].bit_length()
    left = len(data) * 8 - skip              # bits in the stream
    src = data[::-1] + bytes(8)
    mask = (1 << mb) - 1
    i, acc, nacc, used = 1, src[0] & (0xFF >> skip), 8 - skip, 0
    out = bytearray(n)
    for k in range(n):
        if nacc < mb:
            acc = ((acc & ((1 << nacc) - 1)) << 56) | int.from_bytes(
                src[i:i + 7].ljust(7, b"\0"), "big")
            i += 7
            nacc += 56
        j = (acc >> (nacc - mb)) & mask
        out[k] = syms[j]
        ln = lens[j]
        nacc -= ln
        used += ln
    if used != left:
        raise _bad("a Huffman stream not used up by its literals")
    return bytes(out)


# ---------------------------------------------------------- the sections

class _State:
    """What a frame's blocks hand on: the last Huffman table, the three
    sequence tables and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]       # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(data: bytes, st: _State) -> Tuple[bytes, int]:
    """RFC 8878 3.1.1.3.1: the block's literals and the byte after them."""
    b0 = data[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                      # raw or RLE
        if fmt in (0, 2):
            size, at = b0 >> 3, 1
        elif fmt == 1:
            size, at = (b0 >> 4) | (data[1] << 4), 2
        else:
            size, at = (b0 >> 4) | (data[1] << 4) | (data[2] << 12), 3
        if kind == 0:
            if at + size > len(data):
                raise _bad("truncated raw literals")
            return data[at:at + size], at + size
        if at >= len(data):
            raise _bad("truncated RLE literals")
        return data[at:at + 1] * size, at + 1
    head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if head > len(data):
        raise _bad("a truncated literals header")
    h = int.from_bytes(data[:head], "little")
    regen = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    end = head + csize
    if end > len(data):
        raise _bad("truncated compressed literals")
    at = head
    if kind == 2:
        weights, at = _huffman_weights(data[:end], at)
        st.huffman = _huffman_table(weights)
    elif st.huffman is None:
        raise _bad("treeless literals with no tree before them")
    body = data[at:end]
    if fmt == 0:
        return _huffman_stream(body, regen, st.huffman), end
    if len(body) < 6:
        raise _bad("a truncated jump table")
    s1, s2, s3 = struct.unpack("<HHH", body[:6])
    s4 = len(body) - 6 - s1 - s2 - s3
    if s4 < 1:
        raise _bad("a jump table past its literals")
    each = (regen + 3) // 4
    if 3 * each > regen:
        raise _bad("four literal streams for too few literals")
    parts, at = [], 6
    for k, s in enumerate((s1, s2, s3, s4)):
        n = each if k < 3 else regen - 3 * each
        parts.append(_huffman_stream(body[at:at + s], n, st.huffman))
        at += s
    return b"".join(parts), end


_DEFAULTS = None


def _table_for(mode: int, data: bytes, at: int, which: int, st: _State):
    global _DEFAULTS
    if _DEFAULTS is None:
        _DEFAULTS = [_fse_table(*d) for d in (_LL_DEFAULT, _OF_DEFAULT,
                                              _ML_DEFAULT)]
    log_max, sym_max = (_LL_MAX, _OF_MAX, _ML_MAX)[which]
    if mode == 0:
        t = _DEFAULTS[which]
    elif mode == 1:
        if at >= len(data):
            raise _bad("a truncated RLE table")
        if data[at] > sym_max:
            raise _bad("an RLE code out of range")
        t, at = _rle_table(data[at]), at + 1
    elif mode == 2:
        probs, log, at = _fse_description(data, at, log_max, sym_max)
        t = _fse_table(probs, log)
    else:
        t = st.tables[which]
        if t is None:
            raise _bad("a repeated table with none before it")
    st.tables[which] = t
    return t, at


def _sequences(data: bytes, lits: bytes, out: bytearray, st: _State,
               block_max: int):
    """RFC 8878 3.1.1.3.2: decode and execute the sequences, appending the
    block's content, at most `block_max` bytes as libzstd allows, to
    `out`."""
    if not data:
        raise _bad("a block without its sequences section")
    b0 = data[0]
    if b0 == 0:
        if len(data) != 1:
            raise _bad("bytes after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        n, at = b0, 1
    elif b0 < 255:
        n, at = ((b0 - 128) << 8) + data[1], 2
    else:
        n, at = data[1] + (data[2] << 8) + 0x7F00, 3
    if at >= len(data):
        raise _bad("a truncated sequences header")
    modes = data[at]
    at += 1
    if modes & 3:
        raise _bad("reserved bits set in the sequence modes")
    ll_t, at = _table_for(modes >> 6, data, at, 0, st)
    of_t, at = _table_for((modes >> 4) & 3, data, at, 1, st)
    ml_t, at = _table_for((modes >> 2) & 3, data, at, 2, st)
    rd, used = _reader(data[at:])
    lb = lambda t: (len(t) - 1).bit_length()
    ll_s, of_s, ml_s = rd(lb(ll_t)), rd(lb(of_t)), rd(lb(ml_t))
    rep = st.rep
    lit_at = 0
    room = len(out) + block_max
    for k in range(n):
        of_code = of_t[of_s][0]
        ml_code = ml_t[ml_s][0]
        ll_code = ll_t[ll_s][0]
        if of_code > 31:
            raise _bad("an offset code out of range")
        ov = (1 << of_code) + rd(of_code)
        mb, mx = _ML[ml_code]
        ml = mb + (rd(mx) if mx else 0)
        lbase, lx = _LL[ll_code]
        ll = lbase + (rd(lx) if lx else 0)
        if ov > 3:
            off = ov - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = ov + 1 if ll == 0 else ov
            if idx == 1:
                off = rep[0]
            elif idx == 2:
                off = rep[1]
                rep = [off, rep[0], rep[2]]
            elif idx == 3:
                off = rep[2]
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[0] - 1
                rep = [off, rep[0], rep[1]]
        if k + 1 < n:                   # the states, but after the last
            _, nb, base = ll_t[ll_s]
            ll_s = base + rd(nb)
            _, nb, base = ml_t[ml_s]
            ml_s = base + rd(nb)
            _, nb, base = of_t[of_s]
            of_s = base + rd(nb)
        if lit_at + ll > len(lits):
            raise _bad("a sequence past the block's literals")
        out += lits[lit_at:lit_at + ll]
        lit_at += ll
        if off < 1 or off > len(out):
            raise _bad(f"a match offset {off} before the content's start")
        start = len(out) - off
        if len(out) + ml > room:
            raise _bad("a block above the largest size")
        if off >= ml:
            out += out[start:start + ml]
        else:                            # an overlapping copy repeats
            chunk = out[start:]
            q, r = divmod(ml, off)
            out += chunk * q + chunk[:r]
    got, total = used()
    if got != total:
        raise _bad("a sequence bit stream not used up")
    st.rep = rep
    out += lits[lit_at:]


# ---------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the xxHash specification)."""
    n, at = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{stripes * 4}Q", data)
        v1, v2, v3, v4 = v
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) \
            & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        at = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while at + 8 <= n:
        k = _round(0, struct.unpack_from("<Q", data, at)[0])
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        at += 8
    if at + 4 <= n:
        h = (_rotl(h ^ (struct.unpack_from("<I", data, at)[0] * _P1 & _M64),
                   23) * _P2 + _P3) & _M64
        at += 4
    while at < n:
        h = _rotl(h ^ (data[at] * _P5 & _M64), 11) * _P1 & _M64
        at += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- frames

def _frame(data: bytes, at: int, out: bytearray,
           limit: Optional[int] = None) -> int:
    """One Zstandard frame from byte `at` (after its magic) appended to
    `out`; returns the byte after it. With a `limit`, it stops after the
    block that takes the content past `limit` bytes: libzstd's stream
    decoder, given that much room, neither reads on to the frame's end nor
    checks its size and checksum, unless the header's content size fits
    (then it decodes the frame in one pass, checks included)."""
    if at >= len(data):
        raise _bad("a truncated frame header")
    fhd = data[at]
    at += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise _bad("the reserved frame header bit set")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    window = None
    if not single:
        wd = data[at]
        at += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[dict_flag]
    did = int.from_bytes(data[at:at + did_size], "little")
    at += did_size
    if did:
        raise ValueError(f"Zstandard frame needs dictionary {did}, which a "
                         "TIFF strip cannot carry")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    fcs: Optional[int] = None
    if fcs_size:
        if at + fcs_size > len(data):
            raise _bad("a truncated frame header")
        fcs = int.from_bytes(data[at:at + fcs_size], "little")
        fcs += 256 if fcs_size == 2 else 0
        at += fcs_size
    if window is None:
        window = fcs
    block_max = min(window, 1 << 17)
    start = len(out)
    if limit is not None and fcs is not None and fcs <= limit:
        limit = None
    st = _State()
    while True:
        if at + 3 > len(data):
            raise _bad("a truncated block header")
        bh = int.from_bytes(data[at:at + 3], "little")
        at += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 3:
            raise _bad("a reserved block type")
        if kind == 1:
            if at >= len(data):
                raise _bad("a truncated RLE block")
            if size > block_max:
                raise _bad("a block above the largest size")
            out += data[at:at + 1] * size
            at += 1
        else:
            if size > block_max or at + size > len(data):
                raise _bad("a block past the data or above the largest "
                           "size")
            body = data[at:at + size]
            at += size
            if kind == 0:
                out += body
            else:
                lits, used = _literals(body, st)
                if len(lits) > block_max:
                    raise _bad("literals above the largest block size")
                _sequences(body[used:], lits, out, st, block_max)
        if limit is not None and len(out) - start > limit:
            return at
        if last:
            break
    if fcs is not None and len(out) - start != fcs:
        raise _bad(f"{len(out) - start} bytes of content, the header said "
                   f"{fcs}")
    if checksum:
        if at + 4 > len(data):
            raise _bad("a truncated content checksum")
        want = int.from_bytes(data[at:at + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ValueError("Zstandard frame checksum does not match its "
                             "content (restored data is corrupted)")
        at += 4
    return at


def decompress(data: bytes, limit: Optional[int] = None) -> bytes:
    """The content of every frame in `data`, skippable frames passed over,
    as ZSTD_decompress gives it. With a `limit`, as libtiff's ZSTDDecode
    reads a strip into `limit` bytes: ZSTD_decompressStream ends with the
    first frame (a skippable one too) and ignores the bytes after it, or
    once the content is past `limit`; at most `limit` bytes come back."""
    out = bytearray()
    at = 0
    if len(data) < 4:
        raise _bad("no frame")
    while at < len(data) and (limit is None or at == 0):
        if at + 4 > len(data):
            raise _bad("a truncated frame magic")
        magic = struct.unpack_from("<I", data, at)[0]
        at += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            if at + 4 > len(data):
                raise _bad("a truncated skippable frame")
            at += 4 + struct.unpack_from("<I", data, at)[0]
            if at > len(data):
                raise _bad("a truncated skippable frame")
            continue
        if magic != _MAGIC:
            raise _bad("an unknown frame magic")
        at = _frame(data, at, out, limit)
    return bytes(out if limit is None else out[:limit])
