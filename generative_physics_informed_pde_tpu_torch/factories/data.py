"""Named data presets: a random field plus the labeled/unlabeled pools.

Port of the ``highres32`` preset of
``generative_physics_informed_pde_tpu/factories/data.py``: 1024 labeled
fields and 20480 unlabeled ones from a 32^2 squared-exponential field
(mean 0.4, stddev 0.8, corrlength 0.15, Cholesky factor).  The labeled
fields are read read-only from ``cdata/highres32.labeled.npz``; the
unlabeled ones are drawn from the port's random field with the caller's
generator, so the 168 MB unlabeled file is never read.  Nothing here
writes a dataset cache.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.loader import DataLoader
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

    def labeled(self) -> DataLoader:
        """The labeled pool's fields, read-only from
        ``<path>/<identifier>.labeled.npz``."""
        file = self.path / f"{self.identifier}.labeled.npz"
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
        in float64 on ``device`` from the preset's random field."""
        device = resolve_device(device)
        N = self._N_unsupervised if N_u_max is None else int(N_u_max)
        X = self._rfs.sample(generator, batch_size=N, dtype=torch.float64,
                             device=device)
        dlu = DataLoader(X.cpu().numpy())
        dlu.lock_physics_assembly()
        return dlu

    def setup(self, N_u_max: Optional[int] = None,
              generator: Optional[torch.Generator] = None, device="cuda"):
        """-> (labeled loader, unlabeled loader)."""
        device = resolve_device(device)
        return self.labeled(), self.unlabeled(N_u_max, generator, device)


class highres32(DataFactory):
    """32x32 fields, Cholesky factorisation."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._N = 1024
        self._N_unsupervised = 2048 * 10
        self._rfs = GaussianRandomField.from_image(
            32, 32, mean=0.4, stddev=0.80, corrlength=0.15, truncation=None)


_REGISTRY = {"highres32": highres32}
