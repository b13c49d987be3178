"""Named data presets: a random field plus the labeled/unlabeled pools.

Port of the ``highres``, ``highres32`` and ``highres128`` presets of
``generative_physics_informed_pde_tpu/factories/data.py``:

* ``highres``: 2048 labeled and 20480 unlabeled fields from a 64^2
  squared-exponential field (mean 0.4, stddev 0.8, corrlength 0.04,
  adaptive Karhunen-Loeve truncation);
* ``highres32``: 1024 labeled and 20480 unlabeled fields from a 32^2 field
  (mean 0.4, stddev 0.8, corrlength 0.15, Cholesky factor);
* ``highres128``: 2048 labeled and 20480 unlabeled fields from a 128^2
  squared-exponential field (mean 0.4, stddev 0.8, corrlength 0.04, FFT
  circulant embedding).

Without a ``path``, a labeled pool is read read-only from
``cdata/<preset>.labeled.npz`` where that file exists (``highres32``), else
drawn from the preset's field with a generator seeded 0; unlabeled fields
are drawn with the caller's generator (seeded 1 by default), so the 168 MB
unlabeled file is never read, and nothing is written.  The reference seeds
its draws 0 and 1 the same way.

With a ``path`` given by the caller, ``setup`` is the JAX package's dataset
cache under that directory: ``<identifier>.labeled.npz`` and
``<identifier>.unlabeled.npz`` (the JAX package's file format), each with
a sidecar ``.meta.json`` that fingerprints the preset in the same JSON as
the JAX package's, so a cache written by either package is a hit for the
other.  A cache whose fingerprint or contents disagree with the preset
warns (``RuntimeWarning``, "stale") and is drawn again (generators seeded
0 and 1 on the device) and rewritten.
"""

from __future__ import annotations

import json
import os
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.loader import DataLoader, draw_fields
from ..fem.randomfield import GaussianRandomField
from ..utils.device import resolve_device
from ..utils.strings import ensure_file_extension

DATAPATH = Path(__file__).resolve().parents[2] / "cdata"


class DataFactory:
    """Base preset: ``_N`` labeled and ``_N_unsupervised`` unlabeled
    fields of the random field ``_rfs``."""

    _N: int
    _N_unsupervised: int
    _rfs: GaussianRandomField
    _identifier: Optional[str] = None

    def __init__(self, config=None, path: Optional[str] = None):
        self.config = config
        if isinstance(path, str) and not path.endswith("/"):
            raise ValueError(f"path must end with a slash | path={path}")
        self.path = path if path is not None else DATAPATH
        self._cached = path is not None
        self._forced_setup = False

    @property
    def path(self) -> Path:
        """The data directory: the one given to the constructor, where the
        dataset cache lives, else the repository's ``cdata/``, read only
        (a later assignment moves the read-only lookup)."""
        return self._dir

    @path.setter
    def path(self, value):
        self._dir = Path(value)

    @property
    def identifier(self) -> str:
        return self._identifier or type(self).__name__

    @classmethod
    def FromIdentifier(cls, identifier: str, *args, **kwargs):
        try:
            factory_class = _REGISTRY[identifier]
        except KeyError:
            raise KeyError(f"DataFactory cannot provide factory for "
                           f"identifier {identifier!r}")
        return factory_class(*args, **kwargs)

    from_identifier = FromIdentifier

    def labeled(self, device="cuda") -> DataLoader:
        """The labeled pool's fields: read-only from
        ``<path>/<identifier>.labeled.npz`` where it exists, else drawn on
        ``device`` with a generator seeded 0."""
        file = self.path / f"{self.identifier}.labeled.npz"
        if not file.exists():
            return DataLoader(draw_fields(
                self._rfs, self._N, torch.Generator().manual_seed(0),
                device=device))
        with np.load(file, allow_pickle=False) as state:
            X = np.array(state["X"], dtype=np.float64)
            h = bytes(state["hash"]).decode() if "hash" in state else None
        if X.shape[0] != self._N:
            raise ValueError(f"{file.name} holds {X.shape[0]} fields, the "
                             f"preset {self._N}")
        return DataLoader(X, hash=h)

    def unlabeled(self, N_u_max: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> DataLoader:
        """``N_u_max`` (default: the preset's count) unlabeled fields drawn
        in float64 on ``device`` from the preset's random field with
        ``generator`` (default: seeded 1)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(1)
        N = self._N_unsupervised if N_u_max is None else int(N_u_max)
        dlu = DataLoader(draw_fields(self._rfs, N, generator,
                                      device=device))
        dlu.lock_physics_assembly()
        return dlu

    def setup(self, N_u_max: Optional[int] = None,
              generator: Optional[torch.Generator] = None, device="cuda"):
        """-> (labeled loader, unlabeled loader).  With a ``path``: the
        cached pools at their full sizes (``N_u_max`` and ``generator``
        must be None), drawn on ``device`` and written on a miss."""
        device = resolve_device(device)
        if self._cached:
            if N_u_max is not None or generator is not None:
                raise ValueError("a cached preset holds its full pools, "
                                 "drawn from generators seeded 0 and 1; "
                                 "N_u_max and generator need path=None")
            return self._create_dataloaders(device)
        return (self.labeled(device),
                self.unlabeled(N_u_max, generator, device))

    def force_setup(self, device="cuda"):
        """``setup`` that draws and rewrites the cache whatever it holds
        (needs a ``path``)."""
        if not self._cached:
            raise ValueError("force_setup rewrites a dataset cache: give "
                             "the preset a path=")
        self._forced_setup = True
        return self.setup(device=device)

    # ------------------------------------------------------------ cache
    def _cache_meta(self, N: int) -> dict:
        """Fingerprint of what a cached pool depends on, the JAX package's
        dict key for key: a preset edit (N, field statistics, kernel)
        invalidates the cache instead of loading stale fields."""
        rf = self._rfs
        return {"N": int(N), "py": rf.py, "px": rf.px,
                "mean": float(rf.mean), "stddev": float(rf.stddev),
                "corrlength": float(rf.corrlength), "kernel": rf.kernel,
                "truncation": str(rf.truncation)}

    def _create_dataloader(self, N: int, identifier: str, extension: str,
                           seed: int, device="cuda") -> DataLoader:
        """Load ``<path><identifier><extension>`` if its sidecar
        ``.meta.json`` and contents match the preset, else draw ``N``
        fields on ``device`` (a generator seeded ``seed``) and write both
        files.  Writes only under the caller's ``path``: the JAX package
        defaults to the tracked ``cdata/``, the port never writes there."""
        if not self._cached:
            raise ValueError("the dataset cache needs a path=")
        file = ensure_file_extension(str(self.path / identifier), extension)
        meta_file = file + ".meta.json"
        meta = self._cache_meta(N)
        if os.path.exists(file) and not self._forced_setup:
            stale = None
            if os.path.exists(meta_file):
                try:
                    with open(meta_file) as fh:
                        cached = json.load(fh)
                    if cached != meta:
                        stale = f"meta {cached} != {meta}"
                except (OSError, ValueError):
                    stale = "unreadable meta"
            dl = None
            if stale is None:
                dl = DataLoader.from_file(file)
                if dl.N != N or (meta["py"] is not None and
                                 dl.X.shape[1:] != (meta["py"], meta["px"])):
                    stale, dl = (f"cached N={dl.N}/shape={dl.X.shape[1:]}"
                                 f" vs preset N={N}", None)
            if dl is not None:
                if not os.path.exists(meta_file):  # adopt pre-meta caches
                    with open(meta_file, "w") as fh:
                        json.dump(meta, fh)
                return dl
            warnings.warn(f"dataset cache {file} is stale ({stale}); "
                          "resampling", RuntimeWarning)
        os.makedirs(self.path, exist_ok=True)
        dl = DataLoader.from_sampler(self._rfs, N, key=seed,
                                     dtype=torch.float64, device=device)
        dl.save(file)
        with open(meta_file, "w") as fh:
            json.dump(meta, fh)
        return dl

    def _create_dataloaders(self, device="cuda"):
        dl = self._create_dataloader(self._N, self.identifier,
                                     ".labeled.npz", seed=0, device=device)
        dlu = self._create_dataloader(self._N_unsupervised, self.identifier,
                                      ".unlabeled.npz", seed=1,
                                      device=device)
        dlu.lock_physics_assembly()
        return dl, dlu


class highres(DataFactory):
    """64x64 fields, adaptive Karhunen-Loeve truncation."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._N = 2 * 1024
        self._N_unsupervised = 2048 * 10
        self._rfs = GaussianRandomField.from_image(
            64, 64, mean=0.4, stddev=0.80, corrlength=0.04,
            truncation="adaptive")


class highres32(DataFactory):
    """32x32 fields, Cholesky factorisation."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._N = 1024
        self._N_unsupervised = 2048 * 10
        self._rfs = GaussianRandomField.from_image(
            32, 32, mean=0.4, stddev=0.80, corrlength=0.15, truncation=None)


class highres128(DataFactory):
    """128x128 fields, FFT circulant embedding."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._N = 2 * 1024
        self._N_unsupervised = 2048 * 10
        self._rfs = GaussianRandomField.from_image(
            128, 128, mean=0.4, stddev=0.80, corrlength=0.04, method="fft")


_REGISTRY = {"highres": highres, "highres32": highres32,
             "highres128": highres128}
