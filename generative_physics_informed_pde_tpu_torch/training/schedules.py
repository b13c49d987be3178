"""Learning-rate schedules.

Port of ``multistep_lr``, ``step_lr``, ``constant_lr`` and
``make_schedule`` from
``generative_physics_informed_pde_tpu/training/schedules.py``.  A
schedule is a function of the optimiser's update count with optax's
indexing: update n (counted from 0) uses ``schedule(n)``; the trainer sets
each Adam step's learning rate from it.  ``PlateauController`` is the
metric-driven one: the trainer steps it at its monitor points and sets
Adam's learning rate to ``lr_init * scale``.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class PlateauController:
    """ReduceLROnPlateau on a metric (mode 'max' or 'min'): after more
    than ``patience`` steps without an improvement beyond ``threshold``
    the scale is multiplied by ``factor``, floored at ``min_lr /
    lr_init``."""

    patience: int
    threshold: float = 1e-3
    factor: float = 0.1
    min_lr: float = 1e-3
    mode: str = "max"
    lr_init: float = 1e-2

    best: Optional[float] = None
    bad_steps: int = 0
    scale: float = 1.0

    def state_dict(self) -> dict:
        """The mutable state (``best`` None stored as NaN)."""
        return {"best": float("nan") if self.best is None else
                float(self.best),
                "bad_steps": int(self.bad_steps), "scale": float(self.scale)}

    def load_state_dict(self, d: dict) -> None:
        best = float(d["best"])
        self.best = None if math.isnan(best) else best
        self.bad_steps = int(d["bad_steps"])
        self.scale = float(d["scale"])

    def step(self, metric: float) -> float:
        """Take one metric value -> the new scale."""
        metric = float(metric)
        better = (self.best is None or
                  (metric > self.best + self.threshold
                   if self.mode == "max"
                   else metric < self.best - self.threshold))
        if better:
            self.best = metric
            self.bad_steps = 0
        else:
            self.bad_steps += 1
            if self.bad_steps > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / self.lr_init)
                self.bad_steps = 0
        return self.scale
