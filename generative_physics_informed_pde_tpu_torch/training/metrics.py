"""Scalar metrics record.

Port of ``MetricsWriter`` from
``generative_physics_informed_pde_tpu/training/metrics.py`` as an
in-memory store with the same ``add_scalar(tag, value, global_step)``
interface and logging throttle.  The JSONL file and the tensorboard mirror
are not ported: nothing here writes files.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional


class MetricsWriter:
    """In-memory scalar store: tag -> [(step, value)]."""

    def __init__(self, logging_interval: int = 1):
        self.logging_interval = int(logging_interval)
        self.scalars = defaultdict(list)

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None):
        if (self.logging_interval > 1 and global_step is not None
                and global_step % self.logging_interval != 0):
            return
        self.scalars[tag].append((global_step, float(value)))

    def add_scalars(self, logs: dict, global_step: Optional[int] = None,
                    prefix: str = ""):
        for tag, value in logs.items():
            self.add_scalar(tag if "/" in tag else prefix + tag, value,
                            global_step)

    def add_hparams(self, hparam_dict: dict, metric_dict: dict):
        self.hparams = (dict(hparam_dict), dict(metric_dict))
