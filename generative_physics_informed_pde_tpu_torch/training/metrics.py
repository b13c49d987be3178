"""Scalar metrics record.

Port of ``MetricsWriter`` from
``generative_physics_informed_pde_tpu/training/metrics.py``: the
``add_scalar(tag, value, global_step)`` interface with its logging
throttle, an in-memory store (tag -> [(step, value)]) and, with a
``logdir``, a line-buffered JSONL file ``metrics[_comment].jsonl`` there,
mirrored to tensorboard when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Optional


class MetricsWriter:
    """JSONL + in-memory scalar writer."""

    def __init__(self, logdir: Optional[str] = None, comment: str = "",
                 logging_interval: int = 1, mirror_tensorboard: bool = True):
        self.logging_interval = int(logging_interval)
        self.scalars = defaultdict(list)
        self.logdir = logdir
        self.path = None  # the JSONL file
        self._fh = None
        self._tb = None
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            fname = f"metrics{('_' + comment) if comment else ''}.jsonl"
            self.path = os.path.join(logdir, fname)
            # line-buffered: the scalars survive a killed run
            self._fh = open(self.path, "a", buffering=1)
            if mirror_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:  # tensorboard is not installed
                    pass
                else:
                    self._tb = SummaryWriter(log_dir=logdir, comment=comment)

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None):
        if (self.logging_interval > 1 and global_step is not None
                and global_step % self.logging_interval != 0):
            return
        value = float(value)
        self.scalars[tag].append((global_step, value))
        if self._fh is not None:
            self._fh.write(json.dumps({"tag": tag, "step": global_step,
                                       "value": value, "t": time.time()})
                           + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def add_scalars(self, logs: dict, global_step: Optional[int] = None,
                    prefix: str = ""):
        for tag, value in logs.items():
            # tags that already carry a namespace keep it
            self.add_scalar(tag if "/" in tag else prefix + tag, value,
                            global_step)

    def add_hparams(self, hparam_dict: dict, metric_dict: dict):
        self.hparams = (dict(hparam_dict), dict(metric_dict))
        if self._fh is not None:
            self._fh.write(json.dumps({"hparams": hparam_dict,
                                       "metrics": metric_dict}) + "\n")
        if self._tb is not None:
            self._tb.add_hparams(hparam_dict, metric_dict)

    def flush(self):
        if self._fh is not None:
            self._fh.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
