"""Network and data configuration: frozen dataclasses + the `.cf` parser.

The port's own copy of `l3c_tpu/config.py` (the port
imports nothing of `l3c_tpu`): `.cf` files are `key = python_literal`
lines with dotted keys, `#` comments and single inheritance through a
leading `use <parent.cf>` line; `-p key=value` overrides merge on top, and
a key no field takes is an error. The dataclass defaults are
`configs/ms/cr.cf`; the data config's (`dl`) are the JAX package's.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EncConfig:
    cls: str = "EDSRLikeEnc"          # or 'BicubicSubsampling'
    num_blocks: int = 8
    feed_F: bool = True
    importance_map: bool = False


@dataclasses.dataclass(frozen=True)
class DecConfig:
    cls: str = "EDSRDec"
    num_blocks: int = 8
    skip: bool = True


@dataclasses.dataclass(frozen=True)
class QConfig:
    cls: str = "Quantizer"
    C: int = 5
    L: int = 25
    levels_range: Tuple[float, float] = (-1.0, 1.0)
    sigma: float = 2.0


@dataclasses.dataclass(frozen=True)
class ProbConfig:
    K: int = 10


@dataclasses.dataclass(frozen=True)
class MsConfig:
    """Network config; field names mirror configs/ms/cr.cf. The RGB
    bicubic baselines set rgb_bicubic_baseline (every scale is RGB, q.C =
    3); shared_across_scales is parsed as the JAX package parses it, and
    the network does not read it (RGB Shared is one scale applied
    recursively: eval.tester's `recursive`)."""
    num_scales: int = 3
    Cf: int = 64
    kernel_size: int = 3
    rgb_bicubic_baseline: bool = False
    shared_across_scales: bool = False
    enc: EncConfig = EncConfig()
    dec: DecConfig = DecConfig()
    q: QConfig = QConfig()
    prob: ProbConfig = ProbConfig()
    optim: str = "RMSprop"
    lr_initial: float = 1e-4
    lr_schedule: str = "exp_0.75_e5"
    weight_decay: float = 0.0
    dmll_enable_grad: int = 0
    learned_L: bool = False
    after_q1x1: bool = True
    x4_down_in_scale0: bool = False
    # 'float32' (reference parity) or 'bfloat16' (the conv stacks in
    # bfloat16; to_q, the classifier's projection, the quantizer and the
    # mixture stay float32, parameters too)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype = {self.compute_dtype!r}: "
                             "'float32' or 'bfloat16'")
        if self.q.C == 3 and not self.rgb_bicubic_baseline:
            # the RGB-vs-bottleneck split keys on C == 3 (the reference's
            # logistic_mixture.py:68-73): a 3-channel bottleneck would get
            # RGB-style 4-parameter mixtures; the baselines' scales are RGB
            raise ValueError("q.C == 3 collides with the RGB channel-count "
                             "heuristic; use C != 3 for bottlenecks (or "
                             "rgb_bicubic_baseline, where every scale is "
                             "RGB)")

    @property
    def padding_fac(self) -> int:
        return 2 ** self.num_scales


@dataclasses.dataclass(frozen=True)
class DlConfig:
    """Data config; field names mirror configs/dl/oi.cf."""
    batchsize_train: int = 30
    batchsize_val: int = 30
    crop_size: int = 128
    max_epochs: Optional[int] = None
    image_cache_pkl: Optional[str] = None
    train_imgs_glob: str = ""
    val_glob: str = ""
    val_glob_min_size: Optional[int] = None
    num_val_batches: int = 5
    # this image (or <val dir>/fixedimg.{jpg,png} when None) is pinned as
    # the first validation example, center-cropped
    val_fixed_first: Optional[str] = None
    # channel permutation, gamma jitter and vertical flips on top of the
    # crop and horizontal flip (data.images._strong_aug)
    aug_strong: bool = False
    # sample real tiles (basename without the 'x_synth' prefix) this many
    # times as often as synthetic ones; 1 = off
    real_oversample: int = 1


# --------------------------------------------------------------------- parser


def _parse_value(s: str) -> Any:
    s = s.strip()
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s  # bare string


def parse_cf(path: str) -> Dict[str, Any]:
    """Parse a `.cf` file into a flat dict, resolving `use` inheritance:
    keys after a `use <relpath>` line override the parent's."""
    d: Dict[str, Any] = {}
    base = os.path.dirname(path)
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("use "):
                parent_d = parse_cf(os.path.join(base,
                                                 line[len("use "):].strip()))
                parent_d.update(d)
                d = parent_d
                continue
            if "=" not in line:
                raise ValueError(f"{path}: cannot parse line {raw!r}")
            key, val = line.split("=", 1)
            d[key.strip()] = _parse_value(val)
    return d


def _nested(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


_SUB_CONFIGS = {"EncConfig": EncConfig, "DecConfig": DecConfig,
                "QConfig": QConfig, "ProbConfig": ProbConfig}


def _build(cls, d: Dict[str, Any], used: set, prefix: str = ""):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        type_name = f.type if isinstance(f.type, str) else f.type.__name__
        if type_name in _SUB_CONFIGS:
            kwargs[f.name] = _build(_SUB_CONFIGS[type_name], v, used,
                                    prefix + f.name + ".")
        else:
            used.add(prefix + f.name)
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


_FLAT_RENAMES = {"lr.initial": "lr_initial", "lr.schedule": "lr_schedule"}


def _from_dict(cls, flat: Dict[str, Any], kind: str):
    used: set = set()
    cfg = _build(cls, _nested(flat), used)
    unused = [k for k in flat if k not in used]
    if unused:
        raise ValueError(f"Unknown {kind} config keys: {sorted(unused)}")
    return cfg


def ms_config_from_dict(flat: Dict[str, Any]) -> MsConfig:
    """A flat `.cf` dict -> MsConfig; a key no field takes is an error."""
    return _from_dict(MsConfig, {_FLAT_RENAMES.get(k, k): v
                                 for k, v in flat.items()}, "ms")


def dl_config_from_dict(flat: Dict[str, Any]) -> DlConfig:
    """A flat `.cf` dict -> DlConfig; a key no field takes is an error."""
    return _from_dict(DlConfig, flat, "dl")


def load_ms_config(path: str, overrides: Optional[Dict[str, Any]] = None
                   ) -> MsConfig:
    flat = parse_cf(path)
    flat.update(overrides or {})
    return ms_config_from_dict(flat)


def load_dl_config(path: str, overrides: Optional[Dict[str, Any]] = None
                   ) -> DlConfig:
    flat = parse_cf(path)
    flat.update(overrides or {})
    return dl_config_from_dict(flat)


def parse_overrides(specs) -> Dict[str, Any]:
    """Parse `-p key=value` CLI overrides; a bare key is a True flag."""
    out: Dict[str, Any] = {}
    for spec in specs or []:
        if "=" not in spec:
            out[spec] = True
            continue
        k, v = spec.split("=", 1)
        out[k.strip()] = _parse_value(v)
    return out
