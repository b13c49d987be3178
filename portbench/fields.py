"""The benchmark's own random fields: log-conductivity images drawn on the
device from ``--seed`` and an index.

A frozen copy of the port's FFT sampler (``generative_physics_informed_
pde_tpu_torch/fem/randomfield.py``: ``_kernel_fn``,
``GaussianRandomField._fft_factor`` and ``_sample_fft``): circulant
embedding on a torus of twice the grid, ``Re(fft2((a + i b) *
sqrt(spectrum)))`` cropped to the image, plus the mean.  The benchmark
hands the same fields to the program and to the reference; the program's
own sampler is not on any timed path.
"""

from __future__ import annotations

import numpy as np
import torch


def kernel_fn(kernel: str, stddev: float, corrlength: float):
    """Stationary covariance k(r): squared exponential or Matern-3/2."""
    s2, ell = stddev ** 2, corrlength
    if kernel == "se":
        return lambda r: s2 * np.exp(-0.5 * (r / ell) ** 2)
    if kernel == "matern32":
        c = np.sqrt(3.0) / ell
        return lambda r: s2 * (1 + c * r) * np.exp(-c * r)
    raise ValueError(f"unknown kernel {kernel!r}")


def fft_factor(n: int, stddev: float, corrlength: float,
               kernel: str) -> np.ndarray:
    """sqrt of the circulant-embedding spectrum of an (n, n) image of
    pixel width 1/n on the unit square, (2n, 2n) float64."""
    m, w = 2 * n, 1.0 / n
    d = np.minimum(np.arange(m), m - np.arange(m)) * w
    r = np.sqrt(d[:, None] ** 2 + d[None, :] ** 2)
    spec = np.fft.fft2(kernel_fn(kernel, stddev, corrlength)(r)).real
    return np.sqrt(np.clip(spec, 0.0, None) / (m * m))


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of draw ``index`` of run ``seed`` (any whole number;
    the two are folded into one 63-bit seed)."""
    mixed = (int(seed) * 1_000_003 + int(index) * 7_919 + 17) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def sample(n: int, count: int, *, mean: float, stddev: float,
           corrlength: float, kernel: str, gen: torch.Generator,
           dtype=torch.float32, chunk: int = 2048) -> torch.Tensor:
    """(count, n, n) fields on the generator's device: the real noise,
    then the imaginary noise of each chunk, drawn in ``dtype``."""
    device = gen.device
    f = torch.as_tensor(fft_factor(n, stddev, corrlength, kernel),
                        device=device).to(dtype)
    out = torch.empty((count, n, n), dtype=dtype, device=device)
    m = 2 * n
    for lo in range(0, count, chunk):
        k = min(chunk, count - lo)
        a = torch.randn((k, m, m), generator=gen, dtype=dtype, device=device)
        b = torch.randn((k, m, m), generator=gen, dtype=dtype, device=device)
        field = torch.fft.fft2(torch.complex(a, b) * f).real
        out[lo:lo + k] = mean + field[:, :n, :n]
    return out
