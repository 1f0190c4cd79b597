"""Learning-rate schedules from spec strings, as pure step -> lr functions.

Port of `l3c_tpu/train/schedule.py` (the reference's lr_schedule.py
grammar):
    none
    exp_FAC_(iITR|eEPOCH)[_warm_START_FAC_(iITR|eEPOCH)]
    cos_LRMAX_LRMIN_(iITR|eEPOCH)
A schedule is a function of the step alone, so a resumed run needs no
replay. Values are Python floats (the JAX package computes them in
float32; they agree within float32 rounding).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _parse_interval(tok: str, epoch_len: Optional[int]) -> int:
    kind, val = tok[0], tok[1:]
    if kind == "i":
        return int(val)
    if kind == "e":
        if epoch_len is None:
            raise ValueError(f"epoch-based schedule {tok!r} needs epoch_len")
        return max(1, int(float(val) * epoch_len))
    raise ValueError(f"invalid interval spec {tok!r}")


def _exp(initial: float, fac: float, every: int) -> Schedule:
    return lambda step: initial * fac ** (int(step) // every)


def from_spec(spec: str, initial_lr: float,
              epoch_len: Optional[int] = None) -> Schedule:
    if spec == "none":
        return lambda step: float(initial_lr)
    kind, rest = spec.split("_", 1)
    if kind == "exp":
        parts = rest.split("_")
        if len(parts) > 2:
            fac, interval, warm, w_start, w_fac, w_interval = parts
            if warm != "warm":
                raise ValueError(f"invalid schedule {spec!r}")
            base = _exp(initial_lr, float(fac),
                        _parse_interval(interval, epoch_len))
            warm_s = _exp(initial_lr, float(w_fac),
                          _parse_interval(w_interval, epoch_len))
            w_start_itr = (int(w_start) if w_start.isdigit() else
                           int(float(w_start) * epoch_len))

            # one warm restart at w_start_itr, whose decay then holds for
            # good (the reference never restarts twice)
            def lr(step):
                return (base(step) if int(step) < w_start_itr
                        else warm_s(int(step) - w_start_itr))
            return lr
        fac, interval = parts
        return _exp(initial_lr, float(fac),
                    _parse_interval(interval, epoch_len))
    if kind == "cos":
        lrmax, lrmin, t = rest.split("_")
        ti = _parse_interval(t, epoch_len)
        lrmax, lrmin = float(lrmax), float(lrmin)
        return lambda step: lrmin + (lrmax - lrmin) * math.cos(
            math.pi * ((int(step) % ti) / (2.0 * ti)))
    raise ValueError(f"unknown schedule kind {kind!r}")
