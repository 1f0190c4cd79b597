"""The port's Zstandard decoder (data/zstd.py) against libzstd, which
libtiff hands TIFF's ZSTD strips to: frames that libzstd writes through
ctypes (in this test only) at levels 1 to 19, raw, RLE and compressed
blocks, long windows and matches past 128 KiB, content checksums (a
wrong one refused), skippable frames and concatenated frames, XXH64
against the specification's known values, and reading into a bounded
output as libtiff's ZSTDDecode does. Skipped where libzstd is not
installed.
"""
import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from l3c_torch.data import zstd

torch.set_num_threads(1)

_LIB = ctypes.util.find_library("zstd")
pytestmark = pytest.mark.skipif(_LIB is None, reason="libzstd not found")
ZSTD_C_CHECKSUM, ZSTD_C_LEVEL, ZSTD_C_WINDOWLOG = 201, 100, 101


def _lib():
    lib = ctypes.CDLL(_LIB)
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t]
    return lib


def compress(data: bytes, level: int, checksum=False, window_log=0):
    lib = _lib()
    cc = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cc, ZSTD_C_LEVEL, level)
        lib.ZSTD_CCtx_setParameter(cc, ZSTD_C_CHECKSUM, int(checksum))
        if window_log:
            lib.ZSTD_CCtx_setParameter(cc, ZSTD_C_WINDOWLOG, window_log)
        cap = lib.ZSTD_compressBound(ctypes.c_size_t(len(data)))
        buf = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cc, buf, cap, data, len(data))
        assert not lib.ZSTD_isError(ctypes.c_size_t(n))
        return buf.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cc)


def _data(kind: str, n: int, seed: int) -> bytes:
    r = np.random.RandomState(seed)
    if kind == "random":
        return r.randint(0, 256, n).astype(np.uint8).tobytes()
    if kind == "zeros":
        return bytes(n)
    if kind == "skewed":            # Huffman literals of few symbols
        return r.choice(8, n, p=[.5, .2, .1, .08, .05, .04, .02, .01]
                        ).astype(np.uint8).tobytes()
    if kind == "walk":
        return np.cumsum(r.randint(-2, 3, n)).astype(np.uint8).tobytes()
    words = [b"tiff ", b"strip ", b"zstandard ", b"predictor ", b"\x00\x01"]
    return b"".join(words[i] for i in r.randint(0, len(words), n // 6))[:n]


@pytest.mark.parametrize("level", [1, 2, 3, 5, 7, 9, 12, 15, 17, 19])
@pytest.mark.parametrize("kind", ["random", "zeros", "skewed", "walk",
                                  "text"])
def test_levels_equal_libzstd(level, kind):
    data = _data(kind, 30000 + 977 * level, level)
    assert zstd.decompress(compress(data, level)) == data


@pytest.mark.parametrize("n", [0, 1, 2, 31, 32, 33, 255, 256, 1025])
def test_small_frames(n):
    data = _data("text", n, n)
    for level in (1, 19):
        assert zstd.decompress(compress(data, level)) == data


def test_long_window_and_matches_past_128k():
    """A 600 KB stream whose repeats lie 200-400 KB back: several blocks
    of the largest size, matches across them."""
    r = np.random.RandomState(7)
    base = r.randint(0, 256, 200_000).astype(np.uint8).tobytes()
    data = base + _data("walk", 100_000, 1) + base[50_000:] + base[:90_000]
    for level, wlog in ((3, 20), (19, 21)):
        assert zstd.decompress(compress(data, level, window_log=wlog)) \
            == data


def test_checksum_verified_and_a_wrong_one_refused():
    data = _data("walk", 50_000, 3)
    c = compress(data, 5, checksum=True)
    assert c[4] & 4                   # the frame carries the checksum
    assert zstd.decompress(c) == data
    bad = c[:-1] + bytes([c[-1] ^ 0x10])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad)


def test_skippable_and_concatenated_frames():
    a, b = _data("text", 5000, 1), _data("random", 3000, 2)
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") \
        + b"ignored"
    blob = skip + compress(a, 3) + skip + compress(b, 19)
    assert zstd.decompress(blob) == a + b


@pytest.mark.parametrize("cut", [1, 5, 40])
def test_truncated_and_damaged_frames_refused(cut):
    data = _data("walk", 40_000, 5)
    c = compress(data, 9, checksum=True)
    with pytest.raises(ValueError):
        zstd.decompress(c[:-cut])
    with pytest.raises(ValueError):
        zstd.decompress(b"\x28\xb5\x2f\xfe" + c[4:])


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert zstd.xxh64(b"Nobody inspects the spammish repetition") == \
        0xFBCEA83C8A378BF1


def _rle_frame(blocks: int, size: int = 1 << 17) -> bytes:
    """A frame without a content size: `blocks` RLE blocks of `size`
    bytes each, 4 bytes apiece however large they expand."""
    head = (0xFD2FB528).to_bytes(4, "little") + bytes([0, 7 << 3])
    one = ((size << 3) | 2).to_bytes(3, "little") + b"z"
    last = ((size << 3) | 3).to_bytes(3, "little") + b"z"
    return head + one * (blocks - 1) + last


def test_limit_reads_as_libtiff():
    """decompress(data, limit) stops once the content is past `limit`, so
    what lies beyond (more content, a wrong checksum) goes unread, as
    Pillow's libtiff reads a ZSTD strip longer than the strip; a frame
    that ends within `limit` is checked whole; only the first frame is
    read and what follows it is ignored."""
    data = _data("walk", 300_000, 7)
    c = compress(data, 3, checksum=True)
    bad = c[:-1] + bytes([c[-1] ^ 1])
    for limit in (1, 1000, 131_072, 200_000):
        assert zstd.decompress(c, limit) == data[:limit]
        assert zstd.decompress(bad, limit) == data[:limit]
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad, len(data))
    assert zstd.decompress(c, len(data) + 10) == data
    two = compress(data[:5000], 3) + compress(data[5000:9000], 3)
    assert zstd.decompress(two, 9000) == data[:5000]
    assert zstd.decompress(compress(data[:5000], 3) + b"junk", 5000) \
        == data[:5000]
    skip = (0x184D2A50).to_bytes(4, "little") + (4).to_bytes(4, "little")
    assert zstd.decompress(skip + b"abcd" + c, 100) == b""


def test_limit_bounds_the_output():
    """10,000 RLE blocks of 128 KiB (1.3 GB of content in 40 KB) read
    into a bounded output take no more than the limit and one block."""
    frame = _rle_frame(10_000)
    assert len(frame) < 50_000
    assert zstd.decompress(frame, 1000) == b"z" * 1000
    assert zstd.decompress(_rle_frame(3, 5), 100) == b"z" * 15


def test_a_block_that_expands_past_128k_is_refused():
    """A compressed block of 100 matches of 65,539 bytes (6.5 MB from a
    few hundred bytes) is past the largest block: libzstd's stream decoder
    refuses it (test_torch_port_tiff_codecs holds a strip of it against
    Pillow's libtiff), and so does the port, before it writes the block
    out."""
    head = (0xFD2FB528).to_bytes(4, "little") + bytes([0, 7 << 3])
    raw = ((1 << 3) | 0).to_bytes(3, "little") + b"a"
    # no literals; 100 sequences; LL, OF and ML tables RLE: literal
    # length 0, offset code 2 (offset 1), match length code 52 (65539)
    seqs = bytes([100, 0x54, 0, 2, 52]) + bytes(225) + b"\x01"
    body = b"\x00" + seqs
    comp = ((len(body) << 3) | 5).to_bytes(3, "little") + body
    frame = head + raw + comp
    with pytest.raises(ValueError, match="largest"):
        zstd.decompress(frame)
    with pytest.raises(ValueError, match="largest"):
        zstd.decompress(frame, 1000)
