"""Read flax-msgpack checkpoints without msgpack, flax or JAX.

The JAX package saves `{'params', 'opt_state', 'step'}` with flax's
msgpack serializer (l3c_tpu/train/saver.py). Arrays are msgpack ext type 1
whose payload is itself msgpack: `(shape, dtype name, raw C-order bytes)`.
This module is a small msgpack decoder for exactly the types flax writes
(nil, bool, int, float, str, bin, array, map, ext), plus the mapping of a
flax parameter tree onto `MultiscaleNetwork.state_dict()` (HWIO -> OIHW)
and the choice of a log dir's checkpoint for a requested iteration
(`Restorer.restore_params_only` of l3c_tpu/train/saver.py).
"""
from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NATIVE_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}          # bin
        if b in lens:
            return bytes(self.take(self.unpack(lens[b])))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}          # str
        if b in lens:
            return self._str(self.unpack(lens[b]))
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
        if b in lens:
            return self._ext(self.unpack(lens[b]))
        raise ValueError(f"unsupported msgpack type byte {b:#04x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            shape, dtype, raw = unpackb(data)
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
            return arr.reshape(tuple(shape)).astype(np.dtype(dtype))
        if code == _EXT_NATIVE_COMPLEX:
            re_, im_ = unpackb(data)
            return complex(re_, im_)
        if code == _EXT_NPSCALAR:
            shape, dtype, raw = unpackb(data)
            return np.frombuffer(raw, dtype=np.dtype(dtype))[0]
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(buf: bytes) -> Any:
    """Decode one msgpack object (flax's subset) from `buf`."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A flax msgpack checkpoint file -> nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter tree (numpy leaves) -> MultiscaleNetwork state_dict.

    Accepts the checkpoint's `params` entry ({'params': {...}}) or the
    inner module dict. Conv kernels go HWIO -> OIHW; `kernel` becomes
    `weight`, `bias` stays."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    sd = {}
    for name, v in _flatten(tree).items():
        if name.endswith(".kernel"):
            sd[name[:-len("kernel")] + "weight"] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
        else:
            sd[name] = torch.from_numpy(np.array(v))
    return sd


def load_network_weights(net: torch.nn.Module, path: str) -> int:
    """Load a flax checkpoint file's params into `net`; returns its step."""
    ckpt = read_checkpoint(path)
    net.load_state_dict(params_from_jax(ckpt["params"]), strict=True)
    return int(np.asarray(ckpt.get("step", -1)))


CKPT_RE = re.compile(r"ckpt_(\d{10})\.ckpt(\.tmp)?$")


def list_ckpts(log_dir: str) -> List[Tuple[int, str]]:
    """[(iteration, path)] of the checkpoints under <log_dir>/ckpts,
    sorted; temporary ones (.ckpt.tmp) count."""
    ckpt_dir = os.path.join(log_dir, "ckpts")
    if not os.path.isdir(ckpt_dir):
        return []
    found = [(CKPT_RE.match(name), name) for name in os.listdir(ckpt_dir)]
    return sorted((int(m.group(1)), os.path.join(ckpt_dir, name))
                  for m, name in found if m)


def restore_params_only(log_dir: str, itr: int = -1
                        ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """For eval and the codec: (iteration, MultiscaleNetwork state_dict) of
    the checkpoint for `itr` under <log_dir>/ckpts: -1 is the newest, else
    the closest one <= itr (the earliest when all are later)."""
    ckpts = list_ckpts(log_dir)
    if not ckpts:
        raise FileNotFoundError(
            f"no checkpoints in {os.path.join(log_dir, 'ckpts')}")
    at_most = [c for c in ckpts if c[0] <= itr]
    got_itr, path = (ckpts[-1] if itr == -1 else
                     at_most[-1] if at_most else ckpts[0])
    return got_itr, params_from_jax(read_checkpoint(path)["params"])
