"""Optimizers, and their state in the JAX package's checkpoint format.

Port of `l3c_tpu/train/optim.py`, which builds optax chains with the
reference's torch semantics: RMSprop with eps outside the sqrt and alpha
0.99, Adam and plain SGD, weight decay coupled into the gradient before
the core transform, then the learning rate of the schedule. Here those are
torch.optim's own RMSprop, Adam and SGD; the trainer sets the lr of update
n to lr_fn(n) before it, as optax's scale_by_schedule does with its count.

A checkpoint holds the optimizer state as optax's state tree:
    RMSprop  {'0': {'nu': params}, '1': {'count'}}
    Adam     {'0': {'count', 'mu': params, 'nu': params}, '1': {'count'}}
    SGD      {'0': {}, '1': {'count'}}
with weight decay an empty '0' in front and the others shifted by one;
`params` is a tree shaped like the network's flax parameters, and the
last 'count' is the number of updates (the schedule's step).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

from ..config import MsConfig
from ..models.weights import params_from_jax, params_to_jax

RMS_ALPHA, EPS = 0.99, 1e-8
ADAM_BETAS = (0.9, 0.999)


def make_optimizer(cfg: MsConfig, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The optimizer of cfg.optim at lr cfg.lr_initial (the trainer sets
    each update's lr from the schedule)."""
    lr, wd = cfg.lr_initial, cfg.weight_decay
    if cfg.optim == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=RMS_ALPHA, eps=EPS,
                                   weight_decay=wd)
    if cfg.optim == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=EPS,
                                weight_decay=wd)
    if cfg.optim == "SGD":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    raise ValueError(f"unknown optimizer {cfg.optim!r}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


# torch state key -> optax field, per optimizer
_FIELDS = {"RMSprop": {"square_avg": "nu"},
           "Adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
           "SGD": {}}


def _chain(cfg: MsConfig, core: Dict[str, Any], count: int
           ) -> Dict[str, Any]:
    links: List[Dict[str, Any]] = [{}] if cfg.weight_decay else []
    links += [core, {"count": np.asarray(count, np.int32)}]
    return {str(i): v for i, v in enumerate(links)}


def state_tree(cfg: MsConfig, opt: torch.optim.Optimizer,
               named: Mapping[str, torch.nn.Parameter], count: int
               ) -> Dict[str, Any]:
    """The optimizer's state as optax's tree (numpy leaves); parameters
    the optimizer has not stepped yet hold zeros, as optax's init does."""
    core: Dict[str, Any] = {}
    steps = set()
    for key, field in _FIELDS[cfg.optim].items():
        per_param = {}
        for name, p in named.items():
            st = opt.state.get(p, {})
            per_param[name] = st.get(key, torch.zeros_like(p))
            steps.add(int(st.get("step", 0)))
        core[field] = params_to_jax(per_param)
    if cfg.optim == "Adam":
        if len(steps) > 1:
            raise RuntimeError(f"Adam steps differ across parameters: "
                               f"{sorted(steps)}")
        core["count"] = np.asarray(steps.pop() if steps else 0, np.int32)
    return _chain(cfg, core, count)


def load_state_tree(cfg: MsConfig, opt: torch.optim.Optimizer,
                    named: Mapping[str, torch.nn.Parameter],
                    tree: Mapping[str, Any]) -> int:
    """Set the optimizer's state from optax's tree; returns the update
    count (the schedule's step)."""
    links = [tree[str(i)] for i in range(len(tree))]
    if len(links) != (3 if cfg.weight_decay else 2):
        raise ValueError(f"optimizer state of {len(links)} links does not "
                         f"fit {cfg.optim} with weight decay "
                         f"{cfg.weight_decay}")
    core, count = links[-2], int(np.asarray(links[-1]["count"]))
    fields = {key: params_from_jax(core[field])
              for key, field in _FIELDS[cfg.optim].items()}
    step = int(np.asarray(core["count"])) if cfg.optim == "Adam" else count
    opt.state.clear()
    if not fields:
        return count
    for name, p in named.items():
        st = {key: v[name].to(device=p.device, dtype=p.dtype)
              for key, v in fields.items()}
        st["step"] = torch.tensor(float(step))
        opt.state[p] = st
    return count
