"""Evaluation runtime: bpsp over testsets and codec round trips.

Port of `l3c_tpu/eval/tester.py` (the reference's multiscale_tester.py):
- the configs are recovered from the log-dir NAME (utils/logdir) and the
  checkpoint restored for a requested iteration (models/weights)
- bpsp eval: per image auto-crop -> pad -> forward -> bpsp over the true
  (pre-pad) subpixel count -> CropLossCombinator
- write_to_files: real encode + decode + BIT-EXACT assert per image with
  per-stage timings, the end-to-end gate; same-shape images are coded in
  groups through the batched codec
- results cached per (dataset id, restore_itr) in a pickle guarded by an
  interprocess file lock (TestOutputCache)
- `recursive`: the RGB Shared baseline's last scale applied that many more
  times ("auto": 3 for a one-scale baseline, else 0) in the bpsp eval
- sample: sampled reconstructions per image (the paper's Fig. 5)
- codec_backend: 'auto' codes format v8 (TorchBitcoding), 'host' format v1
  (codec.Bitcoding: the network on the device, rANS on the host);
  decode_file picks the codec from the file's version byte.
- with more than one device slot (parallel.mesh.local_devices):
  spatial_shard evaluates images above the auto-crop threshold by height
  sharding (parallel.spatial), and write_to_files(fanout=True) deals the
  groups round-robin over one codec a slot (parallel.fanout).
"""
from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import blueprint
from ..codec import HOST_BACKENDS, auto_crop, make_bitcoding, open_decoder
from ..config import MsConfig, load_ms_config
from ..data.images import Testset, image_size, load_image_uint8, write_png
from ..device import DeviceLike, numerics_guard, resolve
from ..models import weights
from ..models.network import MultiscaleNetwork
from ..parallel import mesh
from ..utils import logdir as logdir_mod
from ..utils import pad as pad_mod
from .timer import StackTimer

class TestID(NamedTuple):
    dataset_id: str
    restore_itr: int


class TestResult:
    def __init__(self):
        self.per_img: Dict[str, float] = {}

    def __setitem__(self, k, v):
        self.per_img[k] = v

    def mean_bpsp(self) -> float:
        return float(np.mean(list(self.per_img.values())))


class TestOutputCache:
    """Result cache guarded by an interprocess file lock: two testers
    sharing one log dir must not lose each other's results in the
    read-modify-write of put() (fcntl.flock on a sidecar .lock file)."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "test_outputs_torch.pkl")
        self._lock_path = self.path + ".lock"

    @contextlib.contextmanager
    def _locked(self):
        import fcntl
        with open(self._lock_path, "a+") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _load(self) -> Dict:
        # only ever this class's own put() wrote the file
        if os.path.isfile(self.path):
            with open(self.path, "rb") as f:
                return pickle.load(f)
        return {}

    def __contains__(self, test_id: TestID) -> bool:
        with self._locked():
            return test_id in self._load()

    def get(self, test_id: TestID):
        with self._locked():
            return self._load().get(test_id)

    def put(self, test_id: TestID, result: TestResult):
        # lock held across load-modify-replace: concurrent put()s
        # serialize instead of last-writer-wins on the whole dict
        with self._locked():
            d = self._load()
            d[test_id] = result
            tmp = self.path + ".write"
            with open(tmp, "wb") as f:
                pickle.dump(d, f)
            os.replace(tmp, self.path)


class EncodeError(Exception):
    pass


class MultiscaleTester:
    def __init__(self, cfg: MsConfig, net: MultiscaleNetwork,
                 log_dir: Optional[str] = None, restore_itr: int = -1,
                 use_cache: bool = True, recursive=0,
                 codec_backend: str = "auto", crop: Optional[int] = None,
                 spatial_shard: bool = False, spatial_halo: int = 32,
                 device: DeviceLike = None):
        """net: a MultiscaleNetwork with its weights loaded; it is moved to
        `device` (the card unless the caller passes "cpu").
        recursive: 0, an int or "auto" (decided from the parsed config:
        3 for the RGB Shared baseline, a one-scale bicubic baseline, else
        0): scales run after the config's, in the bpsp eval only.
        spatial_shard: with more than one device slot, images above the
        auto-crop threshold are evaluated by height sharding over the
        slots with a halo of `spatial_halo` rows instead of independent
        auto-crop tiles."""
        if recursive == "auto":
            recursive = (3 if cfg.rgb_bicubic_baseline
                         and cfg.num_scales == 1 else 0)
        self.recursive = int(recursive)
        if codec_backend != "auto" and codec_backend not in HOST_BACKENDS:
            raise ValueError(f"unknown codec backend {codec_backend!r}")
        self.codec_backend = codec_backend
        self.device = resolve(device)
        numerics_guard()
        self.cfg = cfg
        self.net = net.to(self.device).eval()
        self.spatial_shard = (spatial_shard
                              and len(mesh.local_devices(self.device)) > 1)
        self.spatial_halo = spatial_halo
        self._spatial_cache = {}  # (Hp, Wp) -> the sharded bpsp fn
        self.restore_itr = restore_itr
        # --crop: center-crop every test image to crop x crop before
        # eval/coding
        self.crop = crop
        self.cache = (TestOutputCache(log_dir)
                      if (log_dir and use_cache) else None)
        # skip=0 records everything; StackTimer.means() drops each scope's
        # first (warm-up) sample whenever >= 2 samples exist
        self.times = StackTimer(skip=0, device=self.device)

    @classmethod
    def from_log_dir(cls, log_dir: str, config_roots: List[str],
                     restore_itr: int = -1, **kw) -> "MultiscaleTester":
        _, cf_paths = logdir_mod.parse_log_dir(log_dir, config_roots)
        ms_paths = [p for p in cf_paths if os.sep + "ms" + os.sep in p]
        if not ms_paths:
            raise ValueError(f"no ms config found in {log_dir} name")
        cfg = load_ms_config(ms_paths[0])
        net = MultiscaleNetwork(cfg)
        itr, state_dict = weights.restore_params_only(log_dir, restore_itr)
        net.load_state_dict(state_dict, strict=True)
        return cls(cfg, net, log_dir=log_dir, restore_itr=itr, **kw)

    def _bitcoding(self, coder_profile: Optional[str] = None):
        """The codec of `codec_backend`: TorchBitcoding (v8) or Bitcoding
        (v1, which ignores the profile)."""
        return make_bitcoding(self.cfg, self.net, self.codec_backend,
                              device=self.device, times=self.times,
                              coder_profile=coder_profile)

    # ------------------------------------------------------------- bpsp

    def test(self, testset: Testset) -> TestResult:
        tid = TestID(testset.id, self.restore_itr)
        if self.cache is not None:
            hit = self.cache.get(tid)
            if hit is not None:
                return hit
        result = TestResult()
        for p in testset:
            result[os.path.basename(p)] = self._bpsp_of_image(p)
        if self.cache is not None:
            self.cache.put(tid, result)
        return result

    def test_all(self, testsets: List[Testset]) -> List[tuple]:
        """[(testset_id, mean_bpsp)] — the aligned-table rows."""
        return [(ts.id, self.test(ts).mean_bpsp()) for ts in testsets]

    def _load(self, path: str) -> np.ndarray:
        img = load_image_uint8(path)[None]  # (1,H,W,3)
        if self.crop:
            _, H, W, _ = img.shape
            t = max(0, (H - self.crop) // 2)
            l = max(0, (W - self.crop) // 2)
            img = img[:, t: t + self.crop, l: l + self.crop]
        return img

    def _scale_bpsps(self, crop: np.ndarray) -> torch.Tensor:
        """Theory bpsp of one (1,h,w,3) crop per scale, [scale_0 ..
        scale_{S-1}, uniform tail], over the crop's pre-pad subpixels; with
        recursion the crop is padded for the recursed scales too, and the
        tail is that of the config's coarsest scale's symbols."""
        fac = self.cfg.padding_fac * 2 ** self.recursive
        padded, _ = pad_mod.pad(crop, fac, mode="constant")
        with torch.inference_mode():
            x = torch.from_numpy(padded).to(self.device).to(torch.float32)
            loss = blueprint.compute_loss(
                self.cfg, self.net(x, auto_recurse=self.recursive),
                num_subpixels_before_pad=int(np.prod(crop.shape)),
                auto_recursive_from=(self.cfg.num_scales if self.recursive
                                     else None))
            return torch.stack([torch.as_tensor(b, device=self.device)
                                for b in loss.nonrecursive_bpsps])

    def _bpsp_of_image(self, path: str) -> float:
        img = self._load(path)
        if (self.spatial_shard and auto_crop.needs_crop(img)
                and not self.recursive):
            return self._spatial_bpsp(img)
        comb = auto_crop.CropLossCombinator()
        for crop in auto_crop.iter_crops(img):
            comb.add(float(self._scale_bpsps(crop).sum()),
                     int(np.prod(crop.shape)))
        return comb.get_bpsp()

    def _spatial_bpsp(self, img: np.ndarray) -> float:
        """bpsp of one large image by height sharding over the slots: ONE
        exact forward with the halo exchange instead of independent
        auto-crop tiles. H is padded up to n * 2^S and W to padding_fac by
        replicating the last row and column; the bpsp is rescaled from the
        padded subpixel count to the true one, so numbers compare with
        auto-crop's."""
        from ..parallel import spatial
        _, H, W, _ = img.shape
        devices = mesh.local_devices(self.device)
        n = len(devices)
        S = self.cfg.num_scales
        Hp = H + (-H) % (n * (1 << S))
        # halo: a multiple of 2^S, at least one scale step, at most one
        # slab (the exchange is single-hop)
        halo = max(self.spatial_halo, 1 << S)
        halo += (-halo) % (1 << S)
        halo = min(halo, Hp // n)
        Wp = W + (-W) % self.cfg.padding_fac
        padded = np.zeros((1, Hp, Wp, 3), img.dtype)
        padded[:, :H, :W] = img
        if W < Wp:
            padded[:, :H, W:] = img[:, :, -1:]          # replicate cols
        if H < Hp:
            padded[:, H:] = padded[:, H - 1: H]          # replicate rows
        key = (Hp, Wp)
        if key not in self._spatial_cache:
            self._spatial_cache[key] = spatial.spatial_bpsp_fn(
                self.cfg, self.net, devices, Hp, Wp, halo)
        # the fn divides by the padded subpixel count
        return self._spatial_cache[key](padded) * (Hp * Wp) / (H * W)

    # ------------------------------------------------------- round-trip

    def write_to_files(self, testset: Testset, out_dir: str,
                       time_report: Optional[str] = None,
                       compare_theory: bool = False, group: int = 8,
                       fanout: bool = False) -> TestResult:
        """Encode+decode every image, assert bit-exact, return real bpsp.

        Same-shape images are grouped (up to `group` at a time) through
        the codec's BATCHED encode/decode so the rANS kernels run wide
        instead of once per image; with `fanout` and more than one device
        slot, `group`-sized groups are dealt round-robin over one codec a
        slot (parallel.fanout.CodecFanout), the same groups as without.
        Images above the auto-crop threshold, and every image of the host
        backend, take the single-image path. Grouped files record their
        group's
        fbatch in the header (the determinism contract), so a file coded
        in a group of 8 has slightly different — equally valid — bytes
        than one coded alone.

        compare_theory also evaluates the cross-entropy bpsp per image and
        prints the actual-vs-theory overhead."""
        if self.recursive:
            # neither package codes the recursively applied shared model
            raise NotImplementedError(
                "--write_to_files not implemented for --recursive")
        os.makedirs(out_dir, exist_ok=True)
        # `size` coder profile: eval numbers are bitrate headlines, so
        # spend longer rANS streams (fewer per-stream framing bytes) and
        # the full mixture; serving keeps the faster `balanced` default
        bc = self._bitcoding(coder_profile="size")
        slots = mesh.local_devices(self.device)
        fan = None
        if fanout and len(slots) > 1 and hasattr(bc, "encode_batch"):
            from ..parallel.fanout import CodecFanout
            fan = CodecFanout(self.cfg, self.net, slots, group=group,
                              coder_profile="size")
        # images a codec call: a group on each slot
        chunk_n = group * (len(fan.codecs) if fan is not None else 1)
        result = TestResult()
        # group by post-crop shape without decoding pixels yet
        by_shape: Dict[tuple, List[str]] = {}
        for p in testset:
            h, w = image_size(p)
            if self.crop:
                h, w = min(h, self.crop), min(w, self.crop)
            by_shape.setdefault((h, w), []).append(p)

        def pout_of(p):
            pout = os.path.join(
                out_dir, os.path.splitext(os.path.basename(p))[0] + ".l3c")
            if os.path.exists(pout):
                os.remove(pout)
            return pout

        for (h, w), paths in sorted(by_shape.items()):
            if (not hasattr(bc, "encode_batch")
                    or h * w > auto_crop.needs_crop_dim()):
                for p in paths:
                    self._roundtrip_single(bc, p, pout_of(p), result,
                                           compare_theory)
                continue
            coder = fan if fan is not None else bc
            for i in range(0, len(paths), chunk_n):
                chunk = paths[i: i + chunk_n]
                imgs = [self._load(p) for p in chunk]
                pouts = [pout_of(p) for p in chunk]
                with self.times.run("enc"):
                    bpsps = (fan.encode_paths(imgs, pouts) if fan is not None
                             else bc.encode_batch(imgs, pouts))
                unit_bytes = coder.last_unit_bytes
                with self.times.run("dec"):
                    outs = (fan.decode_paths(pouts) if fan is not None
                            else bc.decode_batch(pouts))
                for b, (p, img, out, bpsp) in enumerate(
                        zip(chunk, imgs, outs, bpsps)):
                    if not np.array_equal(out, img):
                        raise EncodeError(f"round-trip mismatch for {p}")
                    if compare_theory:
                        self._print_theory_comparison(p, img, bc, bpsp,
                                                      unit_bytes[b])
                    result[os.path.basename(p)] = bpsp
                self.times.next_iteration()
        if time_report:
            with open(time_report, "w") as f:
                f.write(self.times.report())
        return result

    def _roundtrip_single(self, bc, p: str, pout: str,
                          result: "TestResult", compare_theory: bool):
        """Single-image round-trip (auto-crop capable)."""
        img = self._load(p)
        with self.times.run("enc"):
            bpsp = bc.encode(img, pout)
        unit_bytes = bc.last_unit_bytes[0]
        with self.times.run("dec"):
            out = bc.decode(pout if not auto_crop.needs_crop(img)
                            else pout + ".part0")
        if not np.array_equal(out, img):
            raise EncodeError(f"round-trip mismatch for {p}")
        if compare_theory:
            self._print_theory_comparison(p, img, bc, bpsp, unit_bytes)
        result[os.path.basename(p)] = bpsp
        self.times.next_iteration()

    def _print_theory_comparison(self, path: str, img: np.ndarray, bc,
                                 actual_bpsp: float, unit_bytes: List[int]):
        """--compare_theory: per-scale theory vs per-unit assumed vs
        actual-on-disk. unit_bytes: THIS image's per-unit byte counts."""
        num_sp = int(np.prod(img.shape))
        # per-scale theory: combine over auto-crop tiles by subpixels
        theory = None
        for crop in auto_crop.iter_crops(img):
            t = self._scale_bpsps(crop).cpu().numpy() \
                * (int(np.prod(crop.shape)) / num_sp)
            theory = t if theory is None else theory + t
        tostr = (lambda v: " | ".join(f"{x:.3f}" for x in v)
                 + f" => {sum(v):.3f}")
        print(f"{os.path.basename(path)} bitrates:")
        print(f"theory:  {tostr(list(theory))}  "
              "(scale_0..scale_N, uniform tail)")
        # assumed: per-unit on-disk bytes mapped onto scales
        per_scale: Dict[str, int] = {}
        for lab, nb in zip(bc.unit_scale_map(), unit_bytes):
            per_scale[lab] = per_scale.get(lab, 0) + nb
        order = [f"scale_{s}" for s in range(self.cfg.num_scales)] \
            + ["uniform"]
        assumed = [per_scale.get(k, 0) * 8 / num_sp for k in order]
        overhead = (sum(assumed) / float(sum(theory)) - 1) * 100
        print(f"assumed: {tostr(assumed)} [{overhead:+.2f}%]")
        print(f"actual:                       => {actual_bpsp:.3f}  "
              f"[{(actual_bpsp / float(sum(theory)) - 1) * 100:+.2f}% "
              "incl. header]")

    # --------------------------------------------------------- sampling

    def sample(self, testset: Testset, out_dir: str,
               sample_scale_sets=((), (0,), (0, 1)), seed: int = 0):
        """Write sampled reconstructions of every image, one PNG per scale
        set, <stem>_sample<scales joined by _>.png (the padded image's
        size): network.sample_forward with a generator seeded `seed` anew
        for each set, clipped and truncated to uint8."""
        os.makedirs(out_dir, exist_ok=True)
        for p in testset:
            padded, _ = pad_mod.pad(self._load(p), self.cfg.padding_fac,
                                    mode="constant")
            with torch.inference_mode():
                x = torch.from_numpy(padded).to(self.device).to(
                    torch.float32)
                for scales in sample_scale_sets:
                    g = torch.Generator(device=self.device).manual_seed(seed)
                    s = self.net.sample_forward(x, g, tuple(scales))
                    arr = np.clip(s[0].cpu().numpy(), 0, 255).astype(
                        np.uint8)
                    name = (os.path.splitext(os.path.basename(p))[0]
                            + "_sample" + "_".join(map(str, scales))
                            + ".png")
                    write_png(os.path.join(out_dir, name), arr)

    # ------------------------------------------------- single-file codec

    def encode_file(self, img_path: str, out_path: str) -> float:
        bc = self._bitcoding()
        img = self._load(img_path)
        if os.path.exists(out_path):
            raise EncodeError(f"{out_path} exists")
        return bc.encode(img, out_path)

    def decode_file(self, in_path: str, out_png: str):
        """Decode a v8 or v1 file (or its .partN set) with the codec its
        version byte names, whatever codec_backend is."""
        parts = in_path
        if not os.path.exists(in_path) and os.path.exists(
                in_path + ".part0"):
            parts = in_path + ".part0"
        bc = open_decoder(parts, self.cfg, self.net, device=self.device,
                          times=self.times)
        write_png(out_png, bc.decode(parts)[0])
