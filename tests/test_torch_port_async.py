"""The codec's async pairs on the CPU: encode_batch_async /
encode_batch_finish, decode_batch_async / decode_batch_finish and
verify_batch_async / verify_batch_finish, against the synchronous calls
and the JAX package's verify program.

On the CPU the pairs run the same work as on the card, without pinned
buffers or events (there is no card to wait for); chip_smoke.py's phase
serve holds them on the card, where they overlap. Held here, exactly:
the pair's files equal encode_batch's byte for byte; encoding batch i
while decoding batch i - 1 gives the bytes and pixels of running them
one after the other; the verify pair gives JAX's flag and hash on the
same pixels.
"""
import os
import sys
import types

import numpy as np
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from l3c_tpu.codec.bitcoding2 import TpuBitcoding  # noqa: E402
from l3c_torch import config as tcfg  # noqa: E402
from l3c_torch.codec import bitcoding2 as b2  # noqa: E402
from l3c_torch.models.network import MultiscaleNetwork  # noqa: E402

torch.set_num_threads(1)


def _codec(dtype="float32"):
    cfg = tcfg.MsConfig(num_scales=3, Cf=8, enc=tcfg.EncConfig(num_blocks=1),
                        dec=tcfg.DecConfig(num_blocks=1),
                        q=tcfg.QConfig(C=5, L=25), prob=tcfg.ProbConfig(K=4),
                        compute_dtype=dtype)
    torch.manual_seed(0)
    return b2.TorchBitcoding(cfg, MultiscaleNetwork(cfg), device="cpu")


def _batch(i, B=2, H=21, W=19):
    return [np.random.RandomState(10 * i + b).randint(
        0, 256, (1, H, W, 3)).astype(np.uint8) for b in range(B)]


def _read(paths):
    return [open(p, "rb").read() for p in paths]


def test_fetch_round_trips_lengths_and_words():
    """One flat int16 buffer carries int32 lengths and u16 words back
    unchanged, in order."""
    lens = torch.tensor([2, 70000, 5, 1 << 30], dtype=torch.int32)
    words = torch.tensor([[0, 65535, 32768], [1, 2, 40000]],
                         dtype=torch.int32)
    got = b2._fetch_finish(b2._fetch_async([(lens, True), (words, False)]))
    np.testing.assert_array_equal(got[0], lens.numpy())
    assert got[1].dtype == np.uint16
    np.testing.assert_array_equal(got[1].astype(np.int64), words.numpy())


def test_encode_pair_writes_encode_batchs_bytes(tmp_path):
    """encode_batch_finish(encode_batch_async(...)) writes encode_batch's
    files byte for byte and returns its bpsp; staged pixels too."""
    bc = _codec()
    imgs = _batch(0, B=3)
    pa = [str(tmp_path / f"a{i}") for i in range(3)]
    pb = [str(tmp_path / f"b{i}") for i in range(3)]
    pc = [str(tmp_path / f"c{i}") for i in range(3)]
    want = bc.encode_batch(imgs, pa)
    assert bc.encode_batch_finish(bc.encode_batch_async(imgs, pb)) == want
    staged = bc.stage_batch(imgs)
    assert bc.encode_batch_finish(
        bc.encode_batch_async(None, pc, staged=staged)) == want
    assert _read(pa) == _read(pb) == _read(pc)


def test_interleaved_encode_and_decode_equal_one_after_the_other(tmp_path):
    """The duplex order (dispatch encode i, dispatch decode i - 1, finish
    both) against encoding and decoding every batch in turn: the same
    files and the same pixels, in float32 and in bfloat16."""
    for dtype in ("float32", "bfloat16"):
        bc = _codec(dtype)
        batches = [_batch(i) for i in range(3)]
        seq = [[str(tmp_path / f"{dtype}s{i}{b}") for b in range(2)]
               for i in range(3)]
        dup = [[str(tmp_path / f"{dtype}d{i}{b}") for b in range(2)]
               for i in range(3)]
        seq_px = []
        for imgs, paths in zip(batches, seq):
            bc.encode_batch(imgs, paths)
            seq_px.append(bc.decode_batch(paths))
        dup_px = [None] * 3
        prev = None
        for i, (imgs, paths) in enumerate(zip(batches, dup)):
            enc = bc.encode_batch_async(imgs, paths)
            dec = bc.decode_batch_async(dup[i - 1]) if prev else None
            bc.encode_batch_finish(enc)
            if dec is not None:
                dup_px[i - 1] = bc.decode_batch_finish(dec)
            prev = paths
        dup_px[2] = bc.decode_batch_finish(bc.decode_batch_async(dup[2]))
        for i in range(3):
            assert _read(seq[i]) == _read(dup[i])
            for a, b, img in zip(seq_px[i], dup_px[i], batches[i]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, img)


def _jax_verify(dec: np.ndarray, ref: np.ndarray):
    """The JAX package's verify_batch_async / _finish program on numpy
    pixels (its jitted flag and hash; it reads nothing else of the
    codec)."""
    jb = types.SimpleNamespace(_verify_jit=None)
    vh = TpuBitcoding.verify_batch_async(jb, dict(imgs=jnp.asarray(dec)),
                                         dict(x=jnp.asarray(ref)))
    return TpuBitcoding.verify_batch_finish(vh)


def test_verify_pair_gives_jaxs_flag_and_hash(tmp_path):
    """verify_batch_finish(verify_batch_async(...)) on a decoded batch left
    on the device: JAX's flag and hash for the same pixels, equal to
    verify_batch's; a flipped bit gives false and another hash, both as
    JAX's."""
    bc = _codec()
    imgs = _batch(1, B=3)
    staged = bc.stage_batch(imgs)
    paths = [str(tmp_path / f"v{i}") for i in range(3)]
    bc.encode_batch(None, paths, staged=staged)
    handle = bc.decode_batch_async(paths)
    got = bc.verify_batch_finish(bc.verify_batch_async(handle, staged))
    ref = staged["x"].numpy()
    assert got == _jax_verify(handle["imgs"].numpy(), ref)
    assert got[0] is True and got == bc.verify_batch(handle, staged)
    bad = handle["imgs"].clone()
    bad[2, 7, 3, 1] ^= 0x80
    got_bad = b2.TorchBitcoding.verify_batch_finish(
        b2.TorchBitcoding.verify_batch_async(dict(imgs=bad), staged))
    assert got_bad == _jax_verify(bad.numpy(), ref)
    assert got_bad[0] is False and got_bad[1] != got[1]
