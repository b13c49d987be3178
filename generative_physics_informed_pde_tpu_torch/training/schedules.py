"""Learning-rate schedules.

Port of ``multistep_lr``, ``step_lr``, ``constant_lr`` and
``make_schedule`` from
``generative_physics_informed_pde_tpu/training/schedules.py``.  A
schedule is a function of the optimiser's update count with optax's
indexing: update n (counted from 0) uses ``schedule(n)``; the trainer sets
each Adam step's learning rate from it.  The host-driven plateau
controller is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def multistep_lr(lr_init: float, milestones: Sequence[int], factor: float,
                 steps_per_update: float = 1) -> Schedule:
    """lr_init scaled by ``factor`` at each milestone (in training
    iterations; ``steps_per_update`` converts to update counts and may be
    fractional).  Milestones that round to the same count each still
    apply their decay."""
    assert factor < 1
    boundaries: dict = {}
    for m in milestones:
        b = max(1, round(int(m) * steps_per_update))
        boundaries[b] = boundaries.get(b, 1.0) * factor
    steps = sorted(boundaries.items())

    def schedule(count: int) -> float:
        lr = lr_init
        for b, scale in steps:
            if count >= b:
                lr *= scale
        return lr

    return schedule


def step_lr(lr_init: float, step_size: int, factor: float = 0.1,
            steps_per_update: float = 1) -> Schedule:
    """Staircase decay by ``factor`` every ``step_size`` iterations."""
    assert factor < 1
    every = max(1, round(step_size * steps_per_update))
    return lambda count: lr_init * factor ** math.floor(count / every)


def constant_lr(lr_init: float) -> Schedule:
    return lambda count: lr_init


def make_schedule(spec: Optional[dict], lr_init: float,
                  steps_per_update: float = 1) -> Schedule:
    """From a reference-style spec: {'milestones': [...], 'factor': f} |
    {'step_size': n, 'factor': f} | None (constant)."""
    if lr_init is None:
        raise ValueError(
            "learning rate is unset (params.trainer['lr_init'] is None); "
            "set it before building the trainer")
    if not spec:
        return constant_lr(lr_init)
    if "milestones" in spec:
        return multistep_lr(lr_init, spec["milestones"], spec["factor"],
                            steps_per_update)
    if "step_size" in spec:
        return step_lr(lr_init, spec["step_size"], spec.get("factor", 0.1),
                       steps_per_update)
    raise ValueError(f"unknown schedule spec {spec}")
