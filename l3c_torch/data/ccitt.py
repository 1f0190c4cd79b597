"""CCITT bilevel coding of TIFF strips (compression 2, 3 and 4), decoded
as libtiff 4.7's tif_fax3.c decodes it under Pillow.

The code tables are ITU-T T.4's (white and black terminating and make-up
codes, the extended make-up codes both colours share) and T.6's 2-D modes
(pass, horizontal, vertical 0 and +-1..3, the extension escape); each row
is decoded to its run lengths, white first, and the runs filled into the
row's bits, black runs as 1-bits (Pillow's raw mode then maps the bits
through the Photometric tag). Where T.4 leaves room the decoder follows
libtiff, whose tables and control flow were read out of Pillow's bundled
library and held against it on damaged files:
  - an EOL is eleven zero bits (its 1 bit is left to the next row's
    SYNC_EOL, which skips zeros up to it); in 2-D rows seven zero bits;
  - the bit accumulator pads a read with zero bits while any real bit is
    left; a read that finds none is the end of the data;
  - compression 2 (Modified Huffman): 1-D rows without EOLs, each row
    starting on a byte boundary; compression 3: every row after an EOL,
    T4Options bit 0 giving a tag bit before each row that says 1-D or
    2-D; compression 4: 2-D rows against the previous row (white before
    the first), no EOLs;
  - a bad code word ends its row: what was decoded stays, the rest is
    white (CLEANUP_RUNS), and decoding goes on with the next row; runs
    that overshoot the width are cut at it, in the run array too;
  - the two run arrays are libtiff's, swapped after each row and kept
    across strips: a reference read past a row's runs finds what an
    earlier row left there;
  - the data ending inside a row fails the strip (Pillow raises), except
    in Group 3 when it ends while SYNC_EOL looks for an EOL's 1 bit:
    libtiff then takes the strip for one without EOLs and decodes it
    again from its first bit, from the row it was at; and in Group 4,
    where the rows before it and that row's decoded part stay (and an
    EOL in a row ends the strip there), failing only when no row was
    finished. The rows a Group 4 strip leaves unwritten keep what
    Pillow's strip buffer held: the previous strip's rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# T.4 Table 2: terminating codes, runs 0..63
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111"
).split()
# T.4 Table 3: make-up codes, runs 64..1728 in steps of 64
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
# T.4 Table 4: the extended make-up codes, runs 1792..2560, either colour
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
# libtiff's tables take eleven zero bits for the EOL and leave its 1 bit to
# the next row's SYNC_EOL
_EOL = "00000000000"

# table states, as libtiff's tif_fax3.h names them
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)
# T.4 Table 1 / T.6 Table 1: the 2-D mode codes
_MAIN = (("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
         ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
         ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
         ("0000001", S_EXT, 0), ("0000000", S_EOL, 0))


def _lookup(codes, bits: int) -> List[Tuple[int, int, int]]:
    """A table of 2^bits entries: the next `bits` bits (MSB first) ->
    (state, code length, run or parameter); S_NULL where no code fits."""
    table = [(S_NULL, 0, 0)] * (1 << bits)
    for code, state, param in codes:
        n = len(code)
        lo = int(code, 2) << (bits - n)
        for i in range(lo, lo + (1 << (bits - n))):
            table[i] = (state, n, param)
    return table


_TABLES: Dict[str, list] = {}


def _tables():
    """The white (12-bit), black (13-bit) and 2-D (7-bit) tables."""
    if not _TABLES:
        ext = [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
        white = ([(c, S_TERMW, i) for i, c in enumerate(_WHITE_TERM)]
                 + [(c, S_MAKEUPW, 64 * (i + 1))
                    for i, c in enumerate(_WHITE_MAKEUP)]
                 + ext + [(_EOL, S_EOL, 0)])
        black = ([(c, S_TERMB, i) for i, c in enumerate(_BLACK_TERM)]
                 + [(c, S_MAKEUPB, 64 * (i + 1))
                    for i, c in enumerate(_BLACK_MAKEUP)]
                 + ext + [(_EOL, S_EOL, 0)])
        _TABLES["white"] = _lookup(white, 12)
        _TABLES["black"] = _lookup(black, 13)
        _TABLES["main"] = _lookup(_MAIN, 7)
    return _TABLES["white"], _TABLES["black"], _TABLES["main"]


class _EOF(Exception):
    """The strip's data ran out (libtiff's premature EOF)."""


class _Bits:
    """libtiff's fax bit accumulator (NeedBits8 / NeedBits16, GetBits,
    ClrBits) over the strip, MSB first."""

    def __init__(self, data: bytes):
        self.data, self.cp, self.acc, self.avail = data, 0, 0, 0

    def need(self, n: int, two: bool = True):
        if self.avail >= n:
            return
        d = self.data
        if self.cp >= len(d):
            if self.avail == 0:
                raise _EOF
            self.acc <<= n - self.avail          # padded with zeros
            self.avail = n
            return
        self.acc = (self.acc << 8) | d[self.cp]
        self.cp += 1
        self.avail += 8
        if self.avail < n and two:
            if self.cp >= len(d):
                self.acc <<= n - self.avail
                self.avail = n
            else:
                self.acc = (self.acc << 8) | d[self.cp]
                self.cp += 1
                self.avail += 8

    def get(self, n: int) -> int:
        return self.acc >> (self.avail - n)

    def clear(self, n: int):
        self.avail -= n
        self.acc &= (1 << self.avail) - 1 if self.avail > 0 else 0

    def lookup(self, table, n: int):
        self.need(n)
        ent = table[self.get(n)]
        self.clear(ent[1])
        return ent


class _Row:
    """One row's runs as libtiff builds them: `runs` (white first), a0,
    and RunLength, the part of the next run already seen."""

    def __init__(self, lastx: int):
        self.runs: List[int] = []
        self.a0 = 0
        self.rl = 0
        self.lastx = lastx

    def setvalue(self, x: int):
        self.runs.append(self.rl + x)
        self.a0 += x
        self.rl = 0

    def cleanup(self):
        """CLEANUP_RUNS: close the pending run, then pad or cut the row to
        its width."""
        if self.rl:
            self.setvalue(0)
        lastx = self.lastx
        if self.a0 != lastx:
            while self.a0 > lastx and self.runs:
                self.a0 -= self.runs.pop()
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if len(self.runs) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)


def _fill(runs: List[int], lastx: int, row: np.ndarray):
    """_TIFFFax3fillruns: white runs clear bits, black runs set them,
    each cut at the row's width in the list too (which then serves as the
    next row's reference, as libtiff's array does)."""
    n = len(runs)
    if n & 1:
        runs.append(0)
    x = 0
    for i in range(len(runs)):
        run = runs[i]
        if x + run > lastx or run > lastx:
            run = runs[i] = lastx - x
        if run:
            row[x:x + run] = i & 1
        x += run
    del runs[n:]            # the pad of an odd count; SETVALUE(0) re-adds


def _expand1d(b: _Bits, r: _Row, white, black) -> bool:
    """EXPAND1D: white and black runs until the width is reached; True
    where an EOL ended the row. Raises _EOF where the data ran out."""
    while True:
        for table, bits, term, mk in ((white, 12, S_TERMW, S_MAKEUPW),
                                      (black, 13, S_TERMB, S_MAKEUPB)):
            while True:
                state, _, param = b.lookup(table, bits)
                if state == S_EOL:
                    r.cleanup()
                    return True
                if state == term:
                    r.setvalue(param)
                    break
                if state in (mk, S_MAKEUP):
                    r.a0 += param
                    r.rl += param
                    continue
                r.cleanup()             # a bad code word ends the row
                return False
            if r.a0 >= r.lastx:
                r.cleanup()
                return False
        if len(r.runs) >= 2 and r.runs[-1] == 0 and r.runs[-2] == 0:
            del r.runs[-2:]


def _horiz(b: _Bits, r: _Row, white, black) -> bool:
    """The two runs of horizontal mode, in the colour order the row is
    at; False where a bad code word ends the row."""
    order = ((black, 13, S_TERMB, S_MAKEUPB), (white, 12, S_TERMW,
                                                S_MAKEUPW))
    if not len(r.runs) & 1:
        order = order[::-1]
    for table, bits, term, mk in order:
        while True:
            state, _, param = b.lookup(table, bits)
            if state == term:
                r.setvalue(param)
                break
            if state in (mk, S_MAKEUP):
                r.a0 += param
                r.rl += param
                continue
            return False
    return True


def _expand2d(b: _Bits, r: _Row, ref: List[int], white, black, main
              ) -> bool:
    """EXPAND2D against the reference row's run array (libtiff's: what
    lies past the row's runs is left from an earlier row); True where an
    EOL ended the row."""
    lastx = r.lastx
    pb = 1
    b1 = ref[0]

    def check_b1():
        nonlocal b1, pb
        if r.runs:
            while b1 <= r.a0 and b1 < lastx:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2

    while r.a0 < lastx:
        b.need(7)
        state, n, param = main[b.get(7)]
        b.clear(n)
        if state == S_PASS:
            check_b1()
            b1 += ref[pb]
            pb += 1
            r.rl += b1 - r.a0
            r.a0 = b1
            b1 += ref[pb]
            pb += 1
        elif state == S_HORIZ:
            if not _horiz(b, r, white, black):
                r.cleanup()
                return False
            check_b1()
        elif state == S_V0:
            check_b1()
            r.setvalue(b1 - r.a0)
            b1 += ref[pb]
            pb += 1
        elif state == S_VR:
            check_b1()
            r.setvalue(b1 - r.a0 + param)
            b1 += ref[pb]
            pb += 1
        elif state == S_VL:
            check_b1()
            if b1 < r.a0 + param:
                r.cleanup()
                return False
            r.setvalue(b1 - r.a0 - param)
            pb -= 1
            b1 -= ref[pb]
        elif state == S_EXT:                 # uncompressed mode: unread
            r.runs.append(lastx - r.a0)
            r.cleanup()
            return False
        elif state == S_EOL:
            r.runs.append(lastx - r.a0)
            b.need(4, two=False)
            b.clear(4)
            r.cleanup()
            return True
        else:
            r.cleanup()
            return False
    if r.rl:
        if r.rl + r.a0 < lastx:              # a final V0 expected
            b.need(1, two=False)
            if not b.get(1):
                r.cleanup()
                return False
            b.clear(1)
        r.setvalue(0)
    r.cleanup()
    return False


class _NoEOL(Exception):
    """The data ended while SYNC_EOL looked for an EOL's 1 bit."""


def _sync_eol(b: _Bits, eolcnt: bool):
    """SYNC_EOL: past the next EOL (11 zero bits, any more zeros, a 1)."""
    if not eolcnt:
        while True:
            b.need(11)
            if b.get(11) == 0:
                break
            b.clear(1)
    while True:
        try:
            b.need(8, two=False)
        except _EOF:
            raise _NoEOL from None
        if b.get(8):
            break
        b.clear(8)
    while not (b.get(1) & 1):
        b.clear(1)
    b.clear(1)


def decode(data: bytes, width: int, rows: int, compression: int,
           t4options: int = 0, buffers: Optional[dict] = None,
           odd_start: bool = False) -> Tuple[np.ndarray, int]:
    """One strip or tile: (rows, width) uint8 bits (1 = a black run) and
    how many rows were decoded in full. Raises ValueError where libtiff
    fails the strip. Compression 32771 (CCITT RLEW) is Modified Huffman
    with each row on a 16-bit boundary of the file (`odd_start`: the strip
    starts at an odd offset). `buffers`, one dict for all strips of an image,
    keeps libtiff's run arrays from strip to strip, as its codec state
    keeps them, and the strip buffer Pillow hands libtiff: rows a Group 4
    strip leaves unwritten keep the previous strip's (zeros before the
    first; Pillow's there are uninitialised).

    Group 3 as libtiff 4.7 reads it: where the data ends while SYNC_EOL
    looks for an EOL's last bit, libtiff takes the strip for one without
    EOLs and decodes it again from its first bit, from the row it was at
    on (FAXMODE_NOEOL; the reference row stays the last one decoded)."""
    white, black, main = _tables()
    if buffers is None:
        buffers = {}
    last = buffers.get("strip")
    out = np.zeros((rows, width), np.uint8)
    if last is not None and last.shape[1] == width:
        out[:min(rows, len(last))] = last[:rows]
    b = _Bits(data)
    # libtiff's two run arrays (Fax3SetupState), swapped after each row
    nruns = -(-(width + 1) // 32) * 32 * (2 if compression == 4
                                          or t4options & 1 else 1)
    if buffers.get("n") != nruns:
        buffers.update(n=nruns, a=[0] * nruns, b=[0] * nruns)
    cur, ref = buffers["a"], buffers["b"]       # Fax3PreDecode's choice
    ref[0], ref[1] = width, 0
    eolcnt, noeol = False, False
    done = 0
    row: Optional[_Row] = None
    try:
        while done < rows:
            row = _Row(width)
            if compression == 2:
                _expand1d(b, row, white, black)
                b.clear(b.avail & 7)        # each row starts a byte
            elif compression == 32771:
                _expand1d(b, row, white, black)
                b.clear(b.avail & 15)       # and a 16-bit word
                if b.avail == 0 and (b.cp + odd_start) & 1:
                    b.cp += 1
            elif compression == 3:
                if not noeol:
                    try:
                        _sync_eol(b, eolcnt)
                    except _NoEOL:
                        b, eolcnt, noeol = _Bits(data), False, True
                        continue
                eolcnt = False
                if t4options & 1:
                    b.need(1, two=False)
                    one_d = b.get(1) & 1
                    b.clear(1)
                else:
                    one_d = True
                if one_d:
                    eolcnt = _expand1d(b, row, white, black)
                else:
                    eolcnt = _expand2d(b, row, ref, white, black, main)
            else:
                eolcnt = _expand2d(b, row, ref, white, black, main)
                if eolcnt:                  # EOFB: the strip ends here
                    _fill(row.runs, width, out[done])
                    if done == 0:
                        raise ValueError("CCITT Group 4 strip ends before "
                                         "its first row")
                    buffers["strip"] = _keep(last, out)
                    return out, done
            _fill(row.runs, width, out[done])
            k = len(row.runs)
            if k >= nruns:
                raise ValueError("CCITT row of more runs than libtiff's "
                                 "buffer holds")
            cur[:k + 1] = row.runs + [0]          # SETVALUE(0) after it
            cur, ref = ref, cur
            done += 1
            row = None
    except IndexError:
        raise ValueError(f"CCITT data at row {done} reads past libtiff's "
                         "run buffer") from None
    except _EOF:
        if row is not None:
            row.cleanup()
            _fill(row.runs, width, out[done])
        if compression != 4 or done == 0:
            raise ValueError(f"CCITT data ends at row {done} of {rows} "
                             "(libtiff: premature EOF)") from None
    buffers["strip"] = _keep(last, out)
    return out, done


def _keep(last: Optional[np.ndarray], out: np.ndarray) -> np.ndarray:
    """The strip buffer after a strip: its rows, and below a short last
    strip what the buffer held before."""
    if last is None or len(last) <= len(out) or \
            last.shape[1] != out.shape[1]:
        return out.copy()
    keep = last.copy()
    keep[:len(out)] = out
    return keep
