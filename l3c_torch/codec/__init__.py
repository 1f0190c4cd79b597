"""Codec backends.

Port of `l3c_tpu/codec/__init__.py`: two implementations of one
capability, told apart in the file by its version byte.

- format v8 (`TorchBitcoding`, the default): the coding CDFs and rANS on
  the device (the hand-written kernels on the card).
- format v1 (`Bitcoding`, format byte 2): host C++ rANS with the CDFs
  evaluated on the fly; the device runs only the network and the
  parameter pack.

`open_decoder` picks the codec a file needs from its version byte.
"""
from __future__ import annotations

import struct

from .bitcoding import MAGIC, Bitcoding, DecodeError
from .bitcoding2 import TorchBitcoding

HOST_BACKENDS = ("host", "cpu", "v1")   # 'cpu' names the entropy backend


def make_bitcoding(cfg, net, backend: str = "auto", device=None,
                   times=None, **kw):
    """backend: 'auto' -> format v8 (TorchBitcoding); 'host' | 'cpu' |
    'v1' -> format v1 (Bitcoding). `device` is where the network runs
    either way (CUDA unless the caller passes "cpu")."""
    if backend == "auto":
        return TorchBitcoding(cfg, net, device=device, times=times, **kw)
    if backend in HOST_BACKENDS:
        return Bitcoding(cfg, net, device=device, times=times, **kw)
    raise ValueError(f"unknown codec backend {backend!r}")


def file_version(path: str) -> int:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise DecodeError(f"{path}: bad magic")
        head = f.read(1)
    if not head:
        raise DecodeError(f"{path}: truncated header")
    return head[0]


def open_decoder(path: str, cfg, net, device=None, times=None):
    """The codec that decodes `path`, chosen by its version byte."""
    v = file_version(path)
    if v == TorchBitcoding.VERSION:
        return TorchBitcoding(cfg, net, device=device, times=times)
    if v == Bitcoding.VERSION:
        return Bitcoding(cfg, net, device=device, times=times)
    raise DecodeError(f"{path}: unsupported format version {v}")
