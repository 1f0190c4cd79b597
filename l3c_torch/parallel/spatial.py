"""Spatial (height) sharding of one image's forward over device slots.

Port of `l3c_tpu/parallel/spatial.py`. When ONE image is too large (or too
latency-critical) for one card, its HEIGHT is split into n slabs, one a
slot, and the multiscale forward runs on every slab, each padded with
`halo` rows of its neighbours (the halo exchange), then cropped back to
its valid interior for the bitcost. Global-image boundaries get zero rows
(in the mean-subtracted domain, as the unsharded forward's zero conv
padding sees), so every interior activation equals the unsharded
forward's once the halo covers the network's receptive field.

The JAX package exchanges the halos with two `ppermute`s inside a
shard_map. The exchange happens once, on the input, before the forward,
so here it is a copy of each neighbour's edge rows onto the slab's card
(`Tensor.to(device, non_blocking=True)`), and the psum of the slabs' nats
is their sum in slab order on the first slot's card. Two slots may name
one card.

Cost model: overlap fraction per slab = 2*halo / (H / n). With the
flagship's receptive field (a halo of ~512 input rows) this pays off for
images of ~8k rows and up on 8 cards.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import blueprint
from ..config import MsConfig
from ..device import DeviceLike
from ..models import dmll, layers
from ..models.network import MultiscaleNetwork
from . import mesh


def halo_exchange(slabs: Sequence[torch.Tensor], halo: int
                  ) -> List[torch.Tensor]:
    """Pad each height slab (N, h, W, C) of a list, slab i on its own
    device, with `halo` rows from each neighbour: its upper neighbour's
    last rows on top, its lower neighbour's first rows below; the global
    top and bottom get zeros. Returns the (N, h + 2*halo, W, C) slabs."""
    n = len(slabs)
    out = []
    for i, x in enumerate(slabs):
        top = (slabs[i - 1][:, -halo:].to(x.device, non_blocking=True)
               if i > 0 else torch.zeros_like(x[:, :halo]))
        bottom = (slabs[i + 1][:, :halo].to(x.device, non_blocking=True)
                  if i < n - 1 else torch.zeros_like(x[:, :halo]))
        out.append(torch.cat([top, x, bottom], dim=1))
    return out


def _check_geometry(cfg: MsConfig, H: int, n: int, halo: int) -> int:
    S = cfg.num_scales
    fac = 1 << S
    if H % n:
        raise ValueError(f"H={H} must divide over {n} devices")
    h = H // n
    if h % fac or halo % fac:
        raise ValueError(
            f"slab height {h} and halo {halo} must be multiples of "
            f"2^num_scales={fac} so every scale's rows split evenly")
    if halo > h:
        # the exchange ships each neighbour's EDGE rows; a halo wider than
        # one slab would need a multi-hop exchange
        raise ValueError(f"halo {halo} exceeds slab height {h}; use "
                         f"fewer devices or a smaller halo")
    return h


def _valid_nats(cfg: MsConfig, out, halo: int) -> torch.Tensor:
    """Total nats of a slab's forward restricted to its VALID rows:
    blueprint.scale_costs_nats + uniform_tail_nats with each scale's maps
    cropped by its halo, halo >> s rows at scale s, so the halo rows (which
    differ from the unsharded forward near the slab edges) never count."""
    spec0, spec_n = blueprint.rgb_spec(cfg), blueprint.bn_spec(cfg)

    def crop(a, s):
        hs = halo >> s
        return a[:, hs: a.shape[1] - hs]

    total = torch.sum(dmll.nll(spec0, crop(out.S[0], 0).to(torch.float32),
                               crop(out.P[0], 0)))
    for i in range(1, len(out.P)):
        target = (out.S[i].to(torch.float32) if cfg.rgb_bicubic_baseline
                  else out.bn[i])
        total = total + torch.sum(dmll.nll(spec_n, crop(target, i),
                                           crop(out.P[i], i)))
    S_last = len(out.S) - 1
    L = 256 if (cfg.rgb_bicubic_baseline or S_last == 0) else cfg.q.L
    tail = crop(out.S[S_last], S_last)
    return total + float(np.prod(tail.shape) * np.log(L))


def spatial_bpsp_fn(cfg: MsConfig, net: MultiscaleNetwork,
                    devices: Sequence[DeviceLike], H: int, W: int,
                    halo: int):
    """fn(img (1, H, W, 3) uint8) -> bpsp of the image, its height split
    over the slots. Equals the unsharded bpsp when `halo` covers the
    receptive field of the whole enc + dec + classifier pyramid, up to a
    boundary effect: the first and last slabs see `halo` explicit zero rows
    at the global edges, where the unsharded forward zero-pads every conv
    layer separately (measured < 0.2 % on total bpsp for the JAX package's
    small config)."""
    devs = mesh.check_slots(devices)
    n = len(devs)
    h = _check_geometry(cfg, H, n, halo)
    nets = mesh.replicas(net, devs)

    @torch.inference_mode()
    def fn(img: np.ndarray) -> float:
        x = np.ascontiguousarray(img[0])
        slabs = []
        for i, d in enumerate(devs):
            with mesh.on(d):
                s = torch.from_numpy(x[i * h: (i + 1) * h]).to(d)
                # exchanged in the MEAN-SUBTRACTED domain, so the zero rows
                # at the global edges match the unsharded forward's zero
                # padding; the forward takes raw [0, 255] (it subtracts the
                # mean and reads scale 0's symbols from the raw values)
                slabs.append(layers.sub_rgb_mean(s.to(torch.float32)[None]))
        padded = halo_exchange(slabs, halo)
        nats = []
        for d, net_d, xp in zip(devs, nets, padded):
            with mesh.on(d):
                mean = torch.as_tensor(255.0 * layers.RGB_MEAN,
                                       dtype=torch.float32, device=d)
                # a contiguous slab: both codec sides' convs see canonical
                # layouts (ROADMAP.md section 3)
                out = net_d((xp + mean).contiguous(), train=False)
                nats.append(_valid_nats(cfg, out, halo))
        total = nats[0]
        for v in nats[1:]:
            total = total + v.to(devs[0])
        return float(total / (np.log(2.0) * H * W * 3))

    return fn


def spatial_bpsp(cfg: MsConfig, net: MultiscaleNetwork,
                 devices: Sequence[DeviceLike], img: np.ndarray,
                 halo: int) -> float:
    """bpsp of ONE (1, H, W, 3) or (H, W, 3) uint8 image, height-sharded."""
    img = img if img.ndim == 4 else img[None]
    _, H, W, _ = img.shape
    return spatial_bpsp_fn(cfg, net, devices, H, W, halo)(img)
