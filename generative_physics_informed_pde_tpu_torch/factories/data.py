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

A labeled pool is read read-only from ``cdata/<preset>.labeled.npz`` where
that file exists (``highres32``), else drawn from the preset's field with a
generator seeded 0; unlabeled fields are drawn with the caller's generator
(seeded 1 by default), so the 168 MB unlabeled file is never read.  The
reference seeds its draws 0 and 1 the same way.  Nothing here writes a
dataset cache.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.loader import DataLoader, draw_fields
from ..fem.randomfield import GaussianRandomField
from ..utils.device import resolve_device

DATAPATH = Path(__file__).resolve().parents[2] / "cdata"


class DataFactory:
    """Base preset: ``_N`` labeled and ``_N_unsupervised`` unlabeled
    fields of the random field ``_rfs``."""

    _N: int
    _N_unsupervised: int
    _rfs: GaussianRandomField

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path is not None else DATAPATH

    @property
    def identifier(self) -> str:
        return type(self).__name__

    @classmethod
    def FromIdentifier(cls, identifier: str, *args, **kwargs):
        try:
            factory_class = _REGISTRY[identifier]
        except KeyError:
            raise KeyError(f"DataFactory cannot provide factory for "
                           f"identifier {identifier!r}")
        return factory_class(*args, **kwargs)

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
        """-> (labeled loader, unlabeled loader)."""
        device = resolve_device(device)
        return (self.labeled(device),
                self.unlabeled(N_u_max, generator, device))


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
