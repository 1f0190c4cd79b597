"""The codec fan-out and the sharded bpsp eval over device slots.

Port of `l3c_tpu/parallel/fanout.py`, in one process over a list of
device slots (mesh.local_devices), as the JAX package runs over
`jax.devices()`:

- `CodecFanout`: one `TorchBitcoding` a slot, each running the same
  kernels at the same shapes on its own card, so a file encoded on one
  slot decodes bit-exactly on another of the same device kind and dtype.
  Work is dealt round-robin in fbatch-sized groups, and every group is
  dispatched (`encode_batch_async` / `decode_batch_async`, on its slot's
  card) before any result is fetched.
- `sharded_eval_fn` / `eval_testset_sharded`: per-example bpsp with one
  example a slot, gathered to the host in slot order, the mean taken there
  in a fixed order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import blueprint
from ..config import MsConfig
from ..device import DeviceLike
from ..models import dmll
from ..models.network import MultiscaleNetwork
from . import mesh


# ----------------------------------------------------------- codec


class CodecFanout:
    """Fan encode/decode batches across device slots, one codec each."""

    def __init__(self, cfg: MsConfig, net: MultiscaleNetwork,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 group: int = 8, coder_profile: Optional[str] = None,
                 coder_topk: Optional[int] = None):
        """devices: the slots (default mesh.local_devices()); they must be
        of one device kind, and every slot codes with cfg's compute dtype:
        files cross neither device kinds nor dtypes (ROADMAP.md section
        3). group: images a codec call (an fbatch size)."""
        from ..codec.bitcoding2 import TorchBitcoding, fbatch_for
        self.devices = mesh.check_slots(
            devices if devices is not None else mesh.local_devices())
        self.group = group
        fbatch_for(group)  # validate group size against FBATCHES
        self.codecs = [TorchBitcoding(cfg, n, device=d,
                                      coder_profile=coder_profile,
                                      coder_topk=coder_topk)
                       for n, d in zip(mesh.replicas(net, self.devices),
                                       self.devices)]
        # per file of the last encode_paths, per unit: bytes on disk
        self.last_unit_bytes: List[List[int]] = []

    def _slot(self, gi: int):
        k = gi % len(self.codecs)
        return self.codecs[k], mesh.on(self.devices[k])

    def encode_paths(self, imgs: Sequence[np.ndarray],
                     pouts: Sequence[str]) -> List[float]:
        """Encode same-shape images, fanned across all slots."""
        if len(imgs) != len(pouts):
            raise ValueError(f"{len(imgs)} images, {len(pouts)} paths")
        groups = _chunk(list(zip(imgs, pouts)), self.group)
        handles = []
        for gi, g in enumerate(groups):   # dispatch phase: every slot
            bc, here = self._slot(gi)
            with here:
                handles.append(bc.encode_batch_async(
                    [im for im, _ in g], [p for _, p in g]))
        bpsps: List[float] = []
        self.last_unit_bytes = []
        for gi, h in enumerate(handles):  # fetch phase
            bc, here = self._slot(gi)
            with here:
                bpsps.extend(bc.encode_batch_finish(h))
            self.last_unit_bytes.extend(bc.last_unit_bytes)
        return bpsps

    def decode_paths(self, pins: Sequence[str]) -> List[np.ndarray]:
        """Decode same-shape files, fanned across all slots."""
        groups = _chunk(list(pins), self.group)
        handles = []
        for gi, g in enumerate(groups):
            bc, here = self._slot(gi)
            with here:
                handles.append(bc.decode_batch_async(g))
        outs: List[np.ndarray] = []
        for gi, h in enumerate(handles):
            bc, here = self._slot(gi)
            with here:
                outs.extend(bc.decode_batch_finish(h))
        return outs


def _chunk(xs: list, n: int) -> List[list]:
    return [xs[i: i + n] for i in range(0, len(xs), n)]


# ------------------------------------------------------------ eval


def _per_example_bpsp_fwd(cfg: MsConfig, net: MultiscaleNetwork):
    """fn(x (B,H,W,3) float on net's device) -> (B,) bpsp per example, on
    the device: each example's NLL summed per scale, plus the uniform tail
    of the coarsest scale."""
    spec0, spec_n = blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg)

    @torch.inference_mode()
    def fwd(x: torch.Tensor) -> torch.Tensor:
        out = net(x, train=False)
        nats = torch.sum(dmll.nll(spec0, out.S[0].to(torch.float32),
                                  out.P[0]), dim=(1, 2, 3))
        for i in range(1, len(out.P)):
            target = (out.S[i].to(torch.float32) if cfg.rgb_bicubic_baseline
                      else out.bn[i])
            nats = nats + torch.sum(dmll.nll(spec_n, target, out.P[i]),
                                    dim=(1, 2, 3))
        last = len(out.S) - 1
        L = 256 if (cfg.rgb_bicubic_baseline or last == 0) else cfg.q.L
        nats = nats + float(np.prod(out.S[last].shape[1:]) * np.log(L))
        return nats / float(np.log(2.0) * np.prod(x.shape[1:]))

    return fwd


def sharded_eval_fn(cfg: MsConfig, net: MultiscaleNetwork,
                    devices: Sequence[DeviceLike]):
    """fn(batch (B,H,W,3) uint8, B a multiple of the slot count) -> (B,)
    numpy per-example bpsp: slot k runs rows [k B/D, (k+1) B/D) on its
    card, every slot dispatched before any result is fetched, the results
    gathered in slot order."""
    devs = mesh.check_slots(devices)
    fwds = [_per_example_bpsp_fwd(cfg, n)
            for n in mesh.replicas(net, devs)]

    def fn(batch: np.ndarray) -> np.ndarray:
        D = len(devs)
        vals = []
        for k, (d, fwd) in enumerate(zip(devs, fwds)):
            with mesh.on(d):
                x = torch.from_numpy(np.ascontiguousarray(
                    mesh.shard_batch(batch, k, D))).to(d)
                vals.append(fwd(x.to(torch.float32)))
        return np.concatenate([v.cpu().numpy() for v in vals])

    return fn


def eval_testset_sharded(cfg: MsConfig, net: MultiscaleNetwork,
                         devices: Sequence[DeviceLike],
                         crops: Sequence[np.ndarray]) -> float:
    """Mean bpsp over same-shape (H,W,3) crops, fanned over the slots in
    slot-count-sized groups. A ragged tail (fewer crops than slots) is
    PADDED with copies of its first crop and the dummy results discarded:
    every crop runs through the same per-example program."""
    fn = sharded_eval_fn(cfg, net, devices)
    D = len(devices)
    vals: List[float] = []
    for g in _chunk(list(crops), D):
        real = len(g)
        g = g + [g[0]] * (D - real)
        vals.extend(fn(np.stack(g))[:real].tolist())
    return float(np.mean(vals))
