"""Device selection and the float settings the codec's determinism needs."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The port's default device: the first CUDA card. Raises when there is
    none — the port never falls back to the CPU on its own; callers that
    want the CPU say so (`device="cpu"`)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "l3c_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on "
            "the CPU")
    return torch.device("cuda")


def resolve(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device, or the default (CUDA) when None."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return dev


def numerics_guard() -> None:
    """Float settings that encode and decode must share.

    The codec's get_P + pack_int_params must give BITWISE equal floats on
    both sides (the v4 fixed-physical-batch contract, see
    codec/bitcoding2.py). cuDNN convolutions default to TF32 and to
    benchmark-picked, possibly nondeterministic algorithms; either would
    let a decode diverge from its encode without raising. So: full float32
    everywhere, deterministic algorithms, no autotuning."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
