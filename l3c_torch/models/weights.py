"""Read and write flax-msgpack checkpoints without msgpack, flax or JAX.

The JAX package saves `{'params', 'opt_state', 'step'}` with flax's
msgpack serializer (l3c_tpu/train/saver.py). Arrays are msgpack ext type 1
whose payload is itself msgpack: `(shape, dtype name, raw C-order bytes)`.
This module is a small msgpack decoder and encoder for exactly the types
flax writes (nil, bool, int, float, str, bin, array, map, ext), plus the
mapping between a flax parameter tree and `MultiscaleNetwork.state_dict()`
(HWIO <-> OIHW) and the choice of a log dir's checkpoint for a requested
iteration (`Restorer.restore_params_only` of l3c_tpu/train/saver.py).
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


def _pack_len(out: List[bytes], n: int, small: Tuple[int, int],
              codes: Tuple[int, int, int]) -> None:
    """The header of a str / bin / array / map / ext of length n: the fix
    form (small = (base, limit)) where it fits, else 8, 16 or 32 bits."""
    base, limit = small
    if n < limit:
        out.append(struct.pack(">B", base | n))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code and n < top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, (bool, np.bool_)):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        # the smallest form, as msgpack's packer chooses it
        if 0 <= v < 0x80 or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        forms = ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
                 (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64))
        if v < 0:
            forms = ((0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
                     (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0))
        for code, fmt, lo, hi in forms:
            if lo <= v < hi:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(v, bytes):
        _pack_len(out, len(v), (0xC4, 0), (0xC4, 0xC5, 0xC6))
        out.append(v)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), (0x90, 16), (0, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, Mapping):
        # keys sorted, as a tree that went through JAX's tree functions
        # reaches flax's serializer
        _pack_len(out, len(v), (0x80, 16), (0, 0xDE, 0xDF))
        for k in sorted(v, key=str):
            _pack(out, str(k))
            _pack(out, v[k])
    elif isinstance(v, (np.ndarray, np.generic)):
        # flax's ndarray extension: (shape, dtype name, C-order bytes)
        arr = np.asarray(v)
        payload = packb([list(arr.shape), arr.dtype.name,
                         np.ascontiguousarray(arr).astype(
                             arr.dtype.newbyteorder("<")).tobytes()])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(struct.pack(">B", fixext[len(payload)]))
        else:
            _pack_len(out, len(payload), (0, 0), (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", _EXT_NDARRAY) + payload)
    else:
        raise TypeError(f"cannot msgpack {type(v).__name__}")


def packb(v: Any) -> bytes:
    """Encode `v` (nested dicts / lists of numpy arrays, ints, floats,
    strings, bytes, None) as flax's msgpack serializer does: arrays and
    numpy scalars as ext type 1, dict keys as sorted strings; a
    checkpoint's tree comes out byte for byte as the JAX package writes
    it."""
    out: List[bytes] = []
    _pack(out, v)
    return b"".join(out)


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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """MultiscaleNetwork state_dict (or any tensors keyed by its names,
    such as an optimizer's per-parameter state) -> the flax parameter tree
    {'params': {...}} with numpy leaves: the inverse of params_from_jax
    (`weight` -> `kernel`, OIHW -> HWIO; `bias` stays)."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy()
        if name.endswith(".weight"):
            name = name[:-len("weight")] + "kernel"
            v = v.transpose(2, 3, 1, 0)
        *path, leaf = name.split(".")
        cur = tree
        for k in path:
            cur = cur.setdefault(k, {})
        cur[leaf] = np.ascontiguousarray(v)
    return {"params": tree}


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


def ckpt_for_itr(log_dir: str, itr: int = -1) -> Tuple[int, str]:
    """(iteration, path) of the checkpoint for `itr` under <log_dir>/ckpts:
    -1 is the newest, else the closest one <= itr (the earliest when all
    are later)."""
    ckpts = list_ckpts(log_dir)
    if not ckpts:
        raise FileNotFoundError(
            f"no checkpoints in {os.path.join(log_dir, 'ckpts')}")
    at_most = [c for c in ckpts if c[0] <= itr]
    return (ckpts[-1] if itr == -1 else
            at_most[-1] if at_most else ckpts[0])


def restore_params_only(log_dir: str, itr: int = -1
                        ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """For eval and the codec: (iteration, MultiscaleNetwork state_dict) of
    the checkpoint ckpt_for_itr picks."""
    got_itr, path = ckpt_for_itr(log_dir, itr)
    return got_itr, params_from_jax(read_checkpoint(path)["params"])
