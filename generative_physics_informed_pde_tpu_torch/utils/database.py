"""Experiment/result databases for parameter studies.

The port's own copy of ``generative_physics_informed_pde_tpu/utils/
database.py``.  Re-implementation of ``ParameterStudy`` /
``ResultsDatabase`` / ``ParallelStudyPoolBoy`` (reference:
utils/database.py:9-503): typed grid-study result stores with tuple keys,
error logging per key, incremental persistence, and a pool supervisor
that drains futures into the study with failure counting and periodic
intermediate saves.  Persistence is the JAX package's JSON format (no
pickle of arbitrary objects), so a file saved by either package loads in
the other with equal contents; files are written only to the path the
caller gives.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class ParameterStudy:
    """Grid-study results DB (reference: utils/database.py:110-374).

    Registered, typed parameters form tuple keys; each key accumulates a
    list of result records; per-key errors are logged separately.
    """

    def __init__(self, parameters: Optional[Sequence[Tuple[str, type]]] = None):
        self._param_names: List[str] = []
        self._param_types: List[type] = []
        self._results: Dict[tuple, list] = {}
        self._errors: Dict[tuple, list] = {}
        if parameters:
            for name, typ in parameters:
                self.register_parameter(name, typ)

    # ------------------------------------------------------------ params
    def register_parameter(self, name: str, typ: type):
        if name in self._param_names:
            raise ValueError(f"parameter {name} already registered")
        self._param_names.append(name)
        self._param_types.append(typ)

    @property
    def parameter_names(self) -> List[str]:
        return list(self._param_names)

    def _check_key(self, key: tuple) -> tuple:
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) != len(self._param_names):
            raise KeyError(f"key {key} does not match registered parameters "
                           f"{self._param_names}")
        for val, typ in zip(key, self._param_types):
            if not isinstance(val, typ):
                raise TypeError(f"key entry {val!r} is not a {typ.__name__}")
        return key

    # ----------------------------------------------------------- results
    def accumulate(self, key: tuple, result: Any):
        key = self._check_key(key)
        self._results.setdefault(key, []).append(result)

    def add(self, key: tuple, result: Any):
        self.accumulate(key, result)

    def get(self, key: tuple) -> list:
        return self._results[self._check_key(key)]

    def keys(self):
        return self._results.keys()

    def __contains__(self, key) -> bool:
        try:
            return self._check_key(key) in self._results
        except (KeyError, TypeError):
            return False

    def num_results(self, key: tuple) -> int:
        return len(self._results.get(self._check_key(key), []))

    def merge(self, other: "ParameterStudy"):
        if other._param_names != self._param_names:
            raise ValueError("cannot merge studies with different parameters")
        for key, vals in other._results.items():
            self._results.setdefault(key, []).extend(vals)
        for key, errs in other._errors.items():
            self._errors.setdefault(key, []).extend(errs)

    def slice(self, **fixed) -> Dict[tuple, list]:
        """All results whose key matches the fixed coordinates."""
        idx = {self._param_names.index(k): v for k, v in fixed.items()}
        return {key: vals for key, vals in self._results.items()
                if all(key[i] == v for i, v in idx.items())}

    # ------------------------------------------------------------ errors
    def notify_about_error_from_key(self, key: tuple, exception):
        key = self._check_key(key)
        self._errors.setdefault(key, []).append(repr(exception))

    @property
    def num_errors(self) -> int:
        return sum(len(v) for v in self._errors.values())

    def errors(self, key: tuple) -> list:
        return self._errors.get(self._check_key(key), [])

    # --------------------------------------------------------------- io
    def save(self, path: str):
        payload = {
            "param_names": self._param_names,
            "param_types": [t.__name__ for t in self._param_types],
            "results": [[list(k), v] for k, v in self._results.items()],
            "errors": [[list(k), v] for k, v in self._errors.items()],
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, default=_jsonify)

    @classmethod
    def load(cls, path: str) -> "ParameterStudy":
        with open(path) as fh:
            payload = json.load(fh)
        types = {"int": int, "float": float, "str": str, "bool": bool}
        study = cls(list(zip(payload["param_names"],
                             [types[t] for t in payload["param_types"]])))
        for key, vals in payload["results"]:
            study._results[tuple(key)] = vals
        for key, errs in payload["errors"]:
            study._errors[tuple(key)] = errs
        return study


def _jsonify(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    raise TypeError(f"not jsonable: {type(obj)}")


class ResultsDatabase:
    """String-keyed results store with completion marks
    (reference: utils/database.py:381-503; the reference's
    ``check_complete`` has a key typo -- fixed here)."""

    def __init__(self):
        self._results: Dict[str, Any] = {}
        self._complete: Dict[str, bool] = {}

    def add_result(self, key: str, value: Any):
        self._results[key] = value
        self._complete.setdefault(key, False)

    def get_result(self, key: str) -> Any:
        return self._results[key]

    def mark_complete(self, key: str):
        if key not in self._results:
            raise KeyError(key)
        self._complete[key] = True

    def check_complete(self, key: str) -> bool:
        return self._complete.get(key, False)

    def keys(self):
        return self._results.keys()

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump({"results": self._results, "complete": self._complete},
                      fh, default=_jsonify)

    @classmethod
    def load(cls, path: str) -> "ResultsDatabase":
        with open(path) as fh:
            payload = json.load(fh)
        db = cls()
        db._results = payload["results"]
        db._complete = payload["complete"]
        return db


class ParallelStudyPoolBoy:
    """Drains a list of (key, future) pairs into a ParameterStudy,
    counting failures and periodically checkpointing partial results
    (reference: utils/database.py:9-107)."""

    def __init__(self, study: ParameterStudy, save_path: Optional[str] = None,
                 save_interval_s: float = 60.0, poll_interval_s: float = 0.05):
        self._study = study
        self._save_path = save_path
        self._save_interval = save_interval_s
        self._poll_interval = poll_interval_s
        self.num_failures = 0

    def collect(self, jobs: Sequence[Tuple[tuple, Any]]):
        """jobs: iterable of (key, future).  Blocks until all are done."""
        pending = list(jobs)
        last_save = time.time()
        while pending:
            still = []
            for key, fut in pending:
                if fut.done():
                    try:
                        self._study.accumulate(key, fut.result())
                    except Exception as e:  # noqa: BLE001 - study-level FT
                        self.num_failures += 1
                        self._study.notify_about_error_from_key(key, e)
                else:
                    still.append((key, fut))
            pending = still
            if (self._save_path is not None
                    and time.time() - last_save > self._save_interval):
                self._study.save(self._save_path)
                last_save = time.time()
            if pending:
                time.sleep(self._poll_interval)
        if self._save_path is not None:
            self._study.save(self._save_path)
        return self._study
