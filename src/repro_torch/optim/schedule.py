"""Learning-rate schedules, after the JAX package's ``optim/schedule.py``.

The learning rate is a host scalar here (the optimizer reads one float a
step), computed in float32 as jnp computes the reference's schedule op by
op: python floats rounded to float32 where they meet a float32 value, each
division a true float32 division, and the cosine the C library's ``cosf``,
which is what XLA's CPU backend calls for a float32 cosine (numpy's and
torch's own float32 cosines round differently in the last bit).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

_F32 = np.float32


@functools.lru_cache(maxsize=None)
def _cosf():
    name = ctypes.util.find_library("m")
    if name is None:
        raise RuntimeError("warmup_cosine: the C math library (libm) was not "
                           "found")
    fn = ctypes.CDLL(name).cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """``schedule(step) -> lr``: linear warm-up to ``peak_lr`` over
    ``warmup_steps``, then a cosine decay to ``floor * peak_lr`` at
    ``total_steps``; a float32 value returned as a Python float."""
    warm_div = _F32(max(warmup_steps, 1))
    cos_div = _F32(max(total_steps - warmup_steps, 1))
    lr32, floor32 = _F32(peak_lr), _F32(floor)
    half = _F32((1 - floor) * 0.5)
    pi32 = _F32(np.pi)

    def schedule(step: int) -> float:
        s = _F32(step)
        if s < _F32(warmup_steps):
            return float(lr32 * s / warm_div)
        frac = min(max((s - _F32(warmup_steps)) / cos_div, _F32(0.0)),
                   _F32(1.0))
        c = _F32(_cosf()(float(pi32 * frac)))
        return float(lr32 * (floor32 + half * (_F32(1.0) + c)))

    return schedule
