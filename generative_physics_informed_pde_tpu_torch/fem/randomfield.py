"""Gaussian random-field sampling: dense Cholesky, Karhunen-Loeve and FFT
circulant paths.

Port of ``generative_physics_informed_pde_tpu/fem/randomfield.py``:
pixel-centre points, the stationary covariance (squared-exponential and the
Matern family) with 1e-12 jitter, the log-normal moment conversion, and
three colourings of white noise chosen by ``method``
('auto' | 'kl' | 'cholesky' | 'fft'):

* 'cholesky': ``mean + L gamma`` with the Cholesky factor of the dense
  covariance (computed on the host in float64 with numpy, as the
  reference does);
* 'kl': ``mean + L gamma`` with the truncated Karhunen-Loeve factor
  ``L = V[:, :k] sqrt(lambda[:k])``, eigenvalues in descending order and
  the adaptive 99.9% explained-variance cut that keeps at least one mode.
  The float64 ``eigh`` of a 4096 x 4096 covariance takes tens of seconds on
  a host, so it runs with ``torch.linalg.eigh`` on the device the field is
  sampled on, once per device;
* 'fft': circulant embedding on a torus of twice the grid, ``torch.fft``
  of complex white noise scaled by the square root of the embedded
  spectrum.

'auto' picks 'fft' beyond 8192 pixel points, 'cholesky' without a
truncation and 'kl' with one.  ``sample_numpy`` and ``subspace`` are the
host numpy side, computed as the JAX package computes them.  Standard normals come from an explicit
``torch.Generator`` through :func:`standard_normal`.  The reference's real
matmul-DFT sampler is a TPU workaround (complex dtypes on a TPU runtime)
and is left out.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def standard_normal(shape, generator, dtype, device) -> torch.Tensor:
    """Standard normals of ``shape`` and ``dtype`` on ``device``, drawn
    from ``generator`` on the generator's own device."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=gen_device).to(device)


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


def squared_exponential_covariance(X: np.ndarray, stddev: float,
                                   corrlength: float) -> np.ndarray:
    """Dense squared-exponential kernel ``sigma^2 exp(-r^2 / (2 l^2))``
    with the 1e-12 jitter, host float64."""
    return stationary_covariance(X, stddev, corrlength, "se")


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
    method: str = "auto"  # 'auto' | 'kl' | 'cholesky' | 'fft'
    kernel: str = "se"

    def __post_init__(self):
        if self.stddev <= 0 or self.corrlength <= 0:
            raise ValueError("stddev and corrlength must be positive")
        if self.method not in ("auto", "kl", "cholesky", "fft"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.method == "fft" and (self.py is None or self.px is None):
            raise ValueError("method='fft' requires a pixel grid "
                             "(use from_image)")

    @classmethod
    def from_image(cls, py, px, mean, stddev, corrlength, truncation=None,
                   ly=1.0, lx=1.0, method="auto", kernel="se"):
        """Field on the pixel centres of a (py, px) image."""
        return cls(mean=mean, stddev=stddev, corrlength=corrlength,
                   X=pixel_center_points(py, px, ly, lx),
                   truncation=truncation, py=py, px=px, method=method,
                   kernel=kernel)

    @property
    def dim_out(self) -> int:
        return self.X.shape[0]

    @property
    def _resolved_method(self) -> str:
        if self.method != "auto":
            return self.method
        if self.py is not None and self.dim_out > 8192:
            return "fft"
        if self.truncation is None:
            return "cholesky"
        return "kl"

    @property
    def dim_in(self) -> int:
        """Standard normals per sample: two grids of the embedding torus
        on the fft path (real and imaginary noise), else the columns of
        the colouring matrix."""
        method = self._resolved_method
        if method == "fft":
            return 2 * int(np.prod(self._fft_factor.shape))
        if method == "cholesky":
            return self.dim_out
        return self._kl_modes(self.eigvals)

    def _device_const(self, name: str, device, make):
        """``make()`` computed once per device and cached."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        key = (name, torch.device(device))
        if key not in cache:
            cache[key] = make()
        return cache[key]

    # -------------------------------------------------------- dense factors
    def _covariance(self) -> np.ndarray:
        return stationary_covariance(self.X, self.stddev, self.corrlength,
                                     self.kernel)

    def _eig(self, device):
        """(eigenvalues, eigenvectors) of the covariance in descending
        order, float64 on ``device``."""
        def make():
            C = torch.as_tensor(self._covariance(), device=device)
            vals, vecs = torch.linalg.eigh(C)
            return vals.flip(0), vecs.flip(1)
        return self._device_const("eig", device, make)

    @property
    def eigvals(self) -> np.ndarray:
        """Descending eigenvalues (host float64) of the first device the
        eigendecomposition ran on, else of a CPU run."""
        cache = self.__dict__.get("_dev_cache", {})
        devices = [d for (name, d) in cache if name == "eig"]
        vals, _ = self._eig(devices[0] if devices else "cpu")
        return vals.cpu().numpy()

    def _kl_modes(self, eigvals) -> int:
        """The truncation as a mode count: an int as given; 'adaptive' or
        a float the reference's 0.999 explained-variance cut (the
        crossing component excluded, at least one mode kept)."""
        trunc = self.truncation
        if isinstance(trunc, str):
            if trunc.lower() != "adaptive":
                raise ValueError(trunc)
            trunc = 0.999
        if isinstance(trunc, float):
            eigvals = np.asarray(eigvals)
            var_explained = np.cumsum(eigvals) / np.sum(eigvals)
            trunc = max(1, int(np.argmax(var_explained > 0.999)))
        if not isinstance(trunc, (int, np.integer)) or trunc < 1 \
                or trunc >= self.dim_out:
            raise ValueError(f"bad truncation {self.truncation}")
        return int(trunc)

    def _L(self, device="cpu") -> torch.Tensor:
        """Colouring matrix (float64 on ``device``): sample = mean + L
        gamma."""
        method = self._resolved_method

        def make():
            if method == "cholesky":
                return torch.as_tensor(np.linalg.cholesky(self._covariance()),
                                       device=device)
            if method == "kl":
                vals, vecs = self._eig(device)
                k = self._kl_modes(vals.cpu().numpy())
                return vecs[:, :k] * torch.sqrt(torch.clamp(vals[:k], min=0))
            raise RuntimeError(method)
        return self._device_const("L", device, make)

    @cached_property
    def _L_numpy(self) -> np.ndarray:
        """The colouring matrix as the JAX package computes it on the host
        (numpy ``cholesky`` / ``eigh``, float64), for the numpy sampler
        and ``subspace``: the same numbers in both packages."""
        method = self._resolved_method
        C = self._covariance()
        if method == "cholesky":
            return np.linalg.cholesky(C)
        if method != "kl":
            raise RuntimeError(method)
        vals, vecs = np.linalg.eigh(C)
        vals, vecs = np.flip(vals, 0).copy(), np.fliplr(vecs).copy()
        k = self._kl_modes(vals)
        return vecs[:, :k] * np.sqrt(np.clip(vals[:k], 0, None))

    def sample_numpy(self, rng: np.random.Generator,
                     batch_size: int) -> np.ndarray:
        """Host sampling with numpy, float64: (batch_size, py, px) images
        (flat vectors off a pixel grid).  Statistically the same as
        ``sample``, another stream; with one ``rng`` seed the same samples
        as the JAX package's ``sample_numpy``."""
        if self._resolved_method == "fft":
            f = self._fft_factor
            my, mx = f.shape
            eps = (rng.standard_normal((batch_size, my, mx))
                   + 1j * rng.standard_normal((batch_size, my, mx)))
            try:  # multithreaded fft when scipy is present
                from scipy import fft as sfft
                spec = sfft.fft2(eps * f, workers=-1)
            except ImportError:  # pragma: no cover
                spec = np.fft.fft2(eps * f)
            return self.mean + spec.real[:, :self.py, :self.px]
        L = self._L_numpy
        gamma = rng.standard_normal((batch_size, L.shape[1]))
        flat = self.mean + gamma @ L.T
        if self.py is not None:
            return flat.reshape(batch_size, self.py, self.px)
        return flat

    def subspace(self) -> np.ndarray:
        """The truncated (Karhunen-Loeve) colouring matrix (dim_out, k),
        host float64; raises for a full-rank factor."""
        L = self._L_numpy
        if L.shape[0] == L.shape[1]:
            raise RuntimeError("subspace requires a truncated factor")
        return L

    # ---------------------------------------------------------- fft factors
    @cached_property
    def _fft_factor(self) -> np.ndarray:
        """sqrt of the circulant-embedding spectrum, (2*py, 2*px) float64."""
        if self.py is None or self.px is None:
            raise ValueError("fft sampling requires a pixel grid")
        py, px = self.py, self.px
        my, mx = 2 * py, 2 * px
        # pixel widths in physical units, read from the stored points; a
        # single pixel is centred at half the domain extent
        wx = (float(self.X[1, 0] - self.X[0, 0]) if px > 1
              else 2.0 * float(self.X[0, 0]))
        wy = (float(self.X[px, 1] - self.X[0, 1]) if py > 1
              else 2.0 * float(self.X[0, 1]))
        # periodic distances on the embedding torus
        dy = np.minimum(np.arange(my), my - np.arange(my)) * wy
        dx = np.minimum(np.arange(mx), mx - np.arange(mx)) * wx
        r = np.sqrt(dy[:, None] ** 2 + dx[None, :] ** 2)
        row = _kernel_fn(self.kernel, self.stddev, self.corrlength)(r)
        spec = np.fft.fft2(row).real
        if spec.min() < -1e-3 * spec.max():
            # the embedding is only approximately valid: clipping these
            # modes understates the variance
            warnings.warn(
                f"circulant embedding has significant negative spectrum "
                f"(min {spec.min():.3e} vs max {spec.max():.3e}); sampled "
                f"covariance will be biased -- use method='kl'/'cholesky' "
                f"or a smaller corrlength", stacklevel=2)
        spec = np.clip(spec, 0.0, None)  # tiny negatives from embedding
        return np.sqrt(spec / (my * mx))

    # ------------------------------------------------------------- sampling
    @property
    def max_sample_batch(self) -> int:
        """Largest sampling batch that keeps the fft sampler's complex
        (n, 2 py, 2 px) intermediates near 256 MB each (complex128, the
        widest draw); at least 1024 up to 256^2 grids.  The dense paths
        take 4096."""
        if self._resolved_method != "fft":
            return 4096
        my, mx = self._fft_factor.shape
        per = 16
        cap = max(8, int(2 ** 28 // (per * my * mx)))
        if per * my * mx <= 4 * 512 * 512:
            cap = max(cap, 1024)
        return cap

    def sample(self, generator: Optional[torch.Generator] = None,
               batch_size: Optional[int] = None,
               gamma: Optional[torch.Tensor] = None,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Draw samples on ``device``: (py, px) images (flat (n,) vectors
        off a pixel grid), with a leading batch axis when ``batch_size`` is
        given.  On the dense paths ``gamma`` (n_batch, dim_in) replaces the
        standard-normal draw of ``generator``."""
        device = resolve_device(device)
        squeeze = batch_size is None
        n = 1 if squeeze else batch_size
        if self._resolved_method == "fft":
            if gamma is not None:
                raise ValueError(
                    "gamma (a stored latent) is only meaningful on the "
                    "dense KL/Cholesky paths; the fft sampler has no "
                    "'sample = mean + L gamma' contract")
            out = self._sample_fft(generator, n, dtype, device)
            return out[0] if squeeze else out
        L = self._L(device).to(dtype)
        if gamma is None:
            gamma = standard_normal((n, L.shape[1]), generator, dtype, device)
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

    def _sample_fft(self, generator, n, dtype, device):
        """Re(fft2((a + i b) * sqrt(spectrum))), cropped to the grid: the
        real noise a, then the imaginary noise b, drawn in ``dtype``."""
        f = self._device_const(
            "fft_factor", device,
            lambda: torch.as_tensor(self._fft_factor, device=device))
        my, mx = f.shape
        a = standard_normal((n, my, mx), generator, dtype, device)
        b = standard_normal((n, my, mx), generator, dtype, device)
        field = torch.fft.fft2(torch.complex(a, b) * f.to(dtype)).real
        field = field[:, :self.py, :self.px]
        return (self.mean + field).to(dtype)
