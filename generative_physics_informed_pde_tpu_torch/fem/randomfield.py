"""Gaussian random-field sampling, dense-covariance (Cholesky) path.

Port of ``GaussianRandomField.from_image`` and its dense pieces from
``generative_physics_informed_pde_tpu/fem/randomfield.py``: pixel-centre
points, the stationary covariance (squared-exponential and the Matern
family) with 1e-12 jitter, the log-normal moment conversion and the
Cholesky colouring matrix ``L``; a sample is ``mean + L gamma`` with
standard-normal ``gamma`` drawn from an explicit ``torch.Generator``.  The
factor is computed once on the host in float64 (numpy), as the reference
does.  The Karhunen-Loeve and FFT circulant paths are not ported yet
(truncated and >8192-point fields raise); the reference's TPU matmul-DFT is
a TPU workaround and is left out.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def pixel_center_points(py: int, px: int, ly: float = 1.0,
                        lx: float = 1.0) -> np.ndarray:
    """(py*px, 2) pixel-centre coordinates, row-major."""
    wx, wy = lx / px, ly / py
    x = np.linspace(0.5 * wx, lx - 0.5 * wx, px)
    y = np.linspace(0.5 * wy, ly - 0.5 * wy, py)
    X, Y = np.meshgrid(x, y)
    return np.stack([X.ravel(), Y.ravel()], axis=1)


def _kernel_fn(kernel: str, stddev: float, corrlength: float):
    """Stationary kernel k(r): 'se' and the Matern family."""
    s2 = stddev ** 2
    ell = corrlength
    k = kernel.lower()
    if k in ("se", "rbf", "gaussian"):
        return lambda r: s2 * np.exp(-0.5 * (r / ell) ** 2)
    if k in ("matern12", "exponential"):
        return lambda r: s2 * np.exp(-r / ell)
    if k == "matern32":
        c = np.sqrt(3.0) / ell
        return lambda r: s2 * (1 + c * r) * np.exp(-c * r)
    if k == "matern52":
        c = np.sqrt(5.0) / ell
        return lambda r: s2 * (1 + c * r + (c * r) ** 2 / 3) * np.exp(-c * r)
    raise ValueError(f"unknown kernel {kernel!r}")


def stationary_covariance(X: np.ndarray, stddev: float, corrlength: float,
                          kernel: str = "se") -> np.ndarray:
    """Dense covariance of the points X (n, d) plus 1e-12 jitter."""
    r = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    C = _kernel_fn(kernel, stddev, corrlength)(r)
    return C + 1e-12 * np.eye(C.shape[0])


def convert_log_mean_std(mean: float, std: float):
    """Log-normal moment conversion: (mu, sigma) of log X for X with the
    given mean and standard deviation."""
    if mean <= 0 or std <= 0:
        raise ValueError
    mu = np.log(mean) - 0.5 * np.log((std / mean) ** 2 + 1)
    sigma = np.sqrt(np.log((std / mean) ** 2 + 1))
    return mu, sigma


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianRandomField:
    """Stationary Gaussian random field on a set of points or a pixel
    grid (identity equality: the points are an ndarray)."""

    mean: float
    stddev: float
    corrlength: float
    X: np.ndarray  # (n, d) sample locations
    truncation: Optional[object] = None
    py: Optional[int] = None
    px: Optional[int] = None
    kernel: str = "se"

    def __post_init__(self):
        if self.stddev <= 0 or self.corrlength <= 0:
            raise ValueError("stddev and corrlength must be positive")
        if self.truncation is not None:
            raise NotImplementedError(
                "the Karhunen-Loeve (truncated) path is not ported yet")
        if self.py is not None and self.dim_out > 8192:
            raise NotImplementedError(
                "fields beyond 8192 points use the FFT circulant path, "
                "which is not ported yet")

    @classmethod
    def from_image(cls, py, px, mean, stddev, corrlength, truncation=None,
                   ly=1.0, lx=1.0, kernel="se"):
        """Field on the pixel centres of a (py, px) image."""
        return cls(mean=mean, stddev=stddev, corrlength=corrlength,
                   X=pixel_center_points(py, px, ly, lx),
                   truncation=truncation, py=py, px=px, kernel=kernel)

    @property
    def dim_out(self) -> int:
        return self.X.shape[0]

    @property
    def dim_in(self) -> int:
        return self._L.shape[1]

    @cached_property
    def _L(self) -> np.ndarray:
        """Colouring matrix (float64): sample = mean + L gamma."""
        C = stationary_covariance(self.X, self.stddev, self.corrlength,
                                  self.kernel)
        return np.linalg.cholesky(C)

    def sample(self, generator: Optional[torch.Generator] = None,
               batch_size: Optional[int] = None,
               gamma: Optional[torch.Tensor] = None,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Draw samples on ``device``: (py, px) images (flat (n,) vectors
        off a pixel grid), with a leading batch axis when ``batch_size`` is
        given.  ``gamma`` (n_batch, dim_in) replaces the standard-normal
        draw of ``generator``, which happens on the generator's device."""
        device = resolve_device(device)
        squeeze = batch_size is None
        n = 1 if squeeze else batch_size
        L = torch.as_tensor(self._L, dtype=dtype, device=device)
        if gamma is None:
            gen_device = generator.device if generator is not None \
                else device
            gamma = torch.randn((n, L.shape[1]), generator=generator,
                                dtype=dtype, device=gen_device)
        else:
            gamma = torch.atleast_2d(torch.as_tensor(gamma, dtype=dtype))
            if not squeeze and gamma.shape[0] != n:
                raise ValueError(f"gamma batch {gamma.shape[0]} != "
                                 f"batch_size {n}")
            n = gamma.shape[0]
            squeeze = squeeze and n == 1
        flat = self.mean + gamma.to(device) @ L.T
        out = flat.reshape(n, self.py, self.px) if self.py is not None \
            else flat
        return out[0] if squeeze else out
