"""Import the reference's released PyTorch checkpoints.

Port of `l3c_tpu/convert/torch_import.py`. Maps the reference
MultiscaleNetwork state_dict (ckpt_*.pt files of its helpers/saver.py)
onto the flax-layout parameter tree the JAX package builds, leaf for leaf
(conv kernels OIHW -> HWIO), so `models.weights.params_from_jax` carries
it into the port's MultiscaleNetwork through the one mapping both
checkpoint formats use. Handled:

- the reference's Sequential index names: encoder body 0..n-1 ResBlocks
  and the final conv at index n, a ResBlock's convs at .body.0 and .body.2
  (ReLU at .body.1), to_q's conv at .to_q.0, the Upsampler's at .tail.0;
- the fixed MeanShift convs (sub_rgb_mean, the RGB head's /128) are
  checked against the constants the network hard-codes, then dropped;
- the quantizer level tables are checked against models.grids, then
  dropped.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import MsConfig
from ..models import grids


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _conv(sd: Dict, key: str) -> Dict:
    return {"kernel": _conv_to_flax(sd[f"{key}.weight"]),
            "bias": sd[f"{key}.bias"]}


def _resblock(sd: Dict, prefix: str) -> Dict:
    return {"conv1": _conv(sd, f"{prefix}.body.0"),
            "conv2": _conv(sd, f"{prefix}.body.2")}


def import_state_dict(sd: Dict[str, np.ndarray], cfg: MsConfig) -> Dict:
    """Reference state_dict (numpy values) -> flax {'params': ...} tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    nb_e, nb_d = cfg.enc.num_blocks, cfg.dec.num_blocks
    params: Dict = {}
    _verify_fixed_convs(sd)
    for s in range(cfg.num_scales):
        # heads.0 = RGBHead (MeanShift + Head), heads.s>=1 = Head
        if not cfg.rgb_bicubic_baseline:
            params[f"head{s}"] = {"conv": _conv(
                sd, "heads.0.head.1.head" if s == 0 else f"heads.{s}.head")}
            enc = {"down": _conv(sd, f"nets.{s}.enc.down"),
                   "to_q": _conv(sd, f"nets.{s}.enc.to_q.0"),
                   "body_out": _conv(sd, f"nets.{s}.enc.body.{nb_e}")}
            for i in range(nb_e):
                enc[f"block{i}"] = _resblock(sd, f"nets.{s}.enc.body.{i}")
            params[f"enc{s}"] = enc
            _verify_levels(sd, f"nets.{s}.enc.levels", cfg)
        dec = {"head": _conv(sd, f"nets.{s}.dec.head"),
               "body_out": _conv(sd, f"nets.{s}.dec.body.{nb_d}"),
               "tail": {"up0": _conv(sd, f"nets.{s}.dec.tail.0")}}
        for i in range(nb_d):
            dec[f"block{i}"] = _resblock(sd, f"nets.{s}.dec.body.{i}")
        params[f"dec{s}"] = dec
        clf = {"atrous": {"lin": _conv(sd, f"prob_clfs.{s}.atrous.lin")}}
        n_rates = len([k for k in sd
                       if re.match(rf"prob_clfs\.{s}\.atrous\.atrous\."
                                   rf"\d+\.weight$", k)])
        for i in range(n_rates):
            clf["atrous"][f"atrous{i}"] = _conv(
                sd, f"prob_clfs.{s}.atrous.atrous.{i}")
        params[f"clf{s}"] = clf
    return {"params": params}


def _verify_fixed_convs(sd: Dict) -> None:
    """The reference stores its fixed normalisation convs as parameters;
    the network implements them as constants, so a checkpoint whose values
    drifted raises here."""
    if "sub_rgb_mean.weight" in sd:
        np.testing.assert_allclose(sd["sub_rgb_mean.weight"].reshape(3, 3),
                                   np.eye(3), atol=1e-6)
        expect = -255.0 * np.asarray([0.4488, 0.4371, 0.4040])
        np.testing.assert_allclose(sd["sub_rgb_mean.bias"], expect,
                                   atol=1e-4)
    if "heads.0.head.0.weight" in sd:
        np.testing.assert_allclose(
            sd["heads.0.head.0.weight"].reshape(3, 3), np.eye(3) / 128.0,
            atol=1e-7)
        np.testing.assert_allclose(sd["heads.0.head.0.bias"], 0.0,
                                   atol=1e-7)


def _verify_levels(sd: Dict, key: str, cfg: MsConfig) -> None:
    if key not in sd:
        return
    lo, hi = cfg.q.levels_range
    np.testing.assert_allclose(sd[key], grids.levels(lo, hi, cfg.q.L),
                               atol=1e-6)


def load_torch_checkpoint(path: str, cfg: MsConfig) -> Tuple[int, Dict]:
    """A reference ckpt_*.pt file -> (itr, flax {'params': ...} tree).
    Accepts the saver's {'net': sd, ...} and {'modules': {'net': sd}}
    layouts and a bare state_dict; without a stored itr, the one in the
    file name."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "net" in blob:
        sd, itr = blob["net"], int(blob.get("itr", -1))
    elif isinstance(blob, dict) and "modules" in blob:
        sd, itr = blob["modules"]["net"], int(blob.get("itr", -1))
    else:
        sd, itr = blob, -1
    sd = {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in sd.items()}
    m = re.search(r"ckpt_(\d+)", path)
    if itr < 0 and m:
        itr = int(m.group(1))
    return itr, import_state_dict(sd, cfg)
