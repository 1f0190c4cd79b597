"""Checkpoint save/restore with the reference's keep policy, in the JAX
package's file format.

Port of `l3c_tpu/train/saver.py`: a checkpoint every `keep_tmp_itr`
iterations, written as `ckpt_{itr:010d}.ckpt.tmp`; every `keep_every`-th
save becomes persistent (renamed; the temporaries before it deleted), and
of the temporaries after the last persistent one the last `keep_tmp_last`
stay. Restore resolves itr == -1 to the latest, otherwise the closest
checkpoint <= itr (the earliest when all are later).

A file holds the tree {'params', 'opt_state', 'step'} of numpy arrays as
flax's msgpack serializer writes it (models/weights.packb), so the JAX
package's Restorer reads the port's checkpoints and the port reads its.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..models.weights import ckpt_for_itr, packb, read_checkpoint


def ckpt_name(itr: int, tmp: bool) -> str:
    return f"ckpt_{itr:010d}.ckpt" + (".tmp" if tmp else "")


class Saver:
    def __init__(self, out_dir: str, keep_tmp_itr: int = 250,
                 keep_every: int = 10, keep_tmp_last: int = 3):
        self.ckpt_dir = os.path.join(out_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep_tmp_itr = keep_tmp_itr
        self.keep_every = keep_every
        self.keep_tmp_last = keep_tmp_last
        self._saved_tmp: List[Tuple[int, str]] = []
        self._num_saves = 0

    def save_due(self, itr: int) -> bool:
        return itr % self.keep_tmp_itr == 0

    def save(self, state: Dict[str, Any], itr: int) -> str:
        """state: tree of numpy arrays with {'params', 'opt_state',
        'step'}."""
        blob = packb(state)
        self._num_saves += 1
        p = os.path.join(self.ckpt_dir, ckpt_name(itr, tmp=True))
        tmp_write = p + ".write"
        with open(tmp_write, "wb") as f:
            f.write(blob)
        os.replace(tmp_write, p)
        self._saved_tmp.append((itr, p))
        if self._num_saves % self.keep_every == 0:
            os.replace(p, os.path.join(self.ckpt_dir,
                                       ckpt_name(itr, tmp=False)))
            self._saved_tmp.pop()
            # the temporaries before a persistent checkpoint go
            for _, q in self._saved_tmp:
                if os.path.exists(q):
                    os.remove(q)
            self._saved_tmp.clear()
        elif len(self._saved_tmp) > self.keep_tmp_last:
            _, oldest = self._saved_tmp.pop(0)
            if os.path.exists(oldest):
                os.remove(oldest)
        return p


def _overlay_state(template, loaded):
    """Overlay a loaded tree onto a template: keys present in both
    recurse, leaves are adopted only when the shapes match; everything
    else keeps the template's value."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            return template
        return {k: (_overlay_state(v, loaded[k]) if k in loaded else v)
                for k, v in template.items()}
    if np.shape(template) != np.shape(loaded):
        return template
    return loaded


def _strict(template, loaded, path: str = ""):
    """loaded, checked to hold every key of the template with the same
    shape (extra keys are ignored, as flax's from_state_dict does)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint: {path or 'root'} is not a dict")
        missing = sorted(set(template) - set(loaded))
        if missing:
            raise ValueError(f"checkpoint: {path or 'root'} lacks "
                             f"{missing}")
        return {k: _strict(v, loaded[k], f"{path}/{k}")
                for k, v in template.items()}
    if np.shape(template) != np.shape(loaded):
        raise ValueError(f"checkpoint: {path} has shape "
                         f"{np.shape(loaded)}, expected "
                         f"{np.shape(template)}")
    return loaded


class Restorer:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir

    def restore(self, template: Dict[str, Any], itr: int = -1,
                strict: bool = True) -> Tuple[int, Dict[str, Any]]:
        """Load the checkpoint for `itr` (weights.ckpt_for_itr) into the
        structure of `template`; returns (itr, state). strict=False adopts
        the subtrees present in both with matching shapes and keeps the
        template's values elsewhere (warm-starting a changed
        architecture); strict raises on a missing key or another shape."""
        got_itr, path = ckpt_for_itr(self.out_dir, itr)
        loaded = read_checkpoint(path)
        if strict:
            return got_itr, _strict(template, loaded)
        return got_itr, _overlay_state(template, loaded)
