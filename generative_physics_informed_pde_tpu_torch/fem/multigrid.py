"""Matrix-free geometric multigrid preconditioner for the batched solver.

Port of ``generative_physics_informed_pde_tpu/fem/multigrid.py``: a
symmetric V-cycle on the nested grid hierarchy, built from the same
closed-form stencils as the fine operator --

* coarse conductivities: the geometric mean over the 8 fine triangles of
  each coarse square,
* smoother: damped Jacobi (symmetric, batched, mask-aware),
* transfer: linear P1 interpolation along the triangulation diagonal and
  its transpose,

on batch-last ``(Ny, Nx, B)`` arrays.  Each step of a level goes through
``ops.vcycle``: the pre-smoothing pair, the residual with its restriction,
the prolongation with the correction and the first post-sweep, and the
second post-sweep are one hand-written kernel each on a card, the coarsest
level's sweeps one more; on the CPU each runs its plain version, the
written-out operations (K1's plain apply, ``_restrict``, ``_prolong``).
The V-cycle runs in its own ``dtype``, bfloat16, float32 or float64, as
the reference's does: levels, smoother, transfers and coarse sweeps all in
that dtype, the residual cast in and the correction cast back.  In
bfloat16 each step widens its inputs to f32, computes there and rounds its
output once (``ops/vcycle.py``).  The reference's ``optimization_barrier``
fences are left out: they keep XLA from fusing the V-cycle into kernels
that fault a TPU runtime.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .grid import StructuredTriGrid
from .assembly import StencilOperator
from .bc import DirichletProfile
from ..ops.vcycle import (vcycle_coarse, vcycle_correct, vcycle_presmooth,
                          vcycle_restrict, vcycle_smooth)
from ..utils.time import span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}
# the span of ``vcycle(li, .)``, which covers every coarser level too
_LEVEL_SPANS = tuple(f"mg.level{li}" for li in range(32))


def check_precond_dtype(dtype: str) -> str:
    """``dtype`` if it names a V-cycle dtype, else ValueError."""
    if dtype not in _DTYPES:
        raise ValueError(f"the V-cycle dtype must be 'bfloat16', 'float32' "
                         f"or 'float64', got {dtype!r}")
    return dtype


def _coarsen_alpha_cellgrid(a: torch.Tensor) -> torch.Tensor:
    """Cell-grid conductivities (ny, nx, 2, B) -> (ny/2, nx/2, 2, B) via
    the geometric mean over each coarse square's 8 fine triangles."""
    ny, nx = a.shape[0], a.shape[1]
    blocks = torch.log(a).reshape(ny // 2, 2, nx // 2, 2, 2, a.shape[-1])
    m = blocks.mean(dim=(1, 3, 4))                        # (ny/2, nx/2, B)
    return torch.exp(m)[:, :, None, :].expand(-1, -1, 2, -1).contiguous()


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a (n slices) and b (n-1 slices) along ``axis`` -> (2n-1 slices):
    a0 b0 a1 b1 ... a_{n-1}.  Strided slice assignment (the reference's
    stack+reshape avoids strided scatters, which a TPU runtime lowers
    badly; the values are the same)."""
    a_, b_ = a.movedim(axis, 0), b.movedim(axis, 0)
    out = a_.new_empty((2 * a_.shape[0] - 1,) + tuple(a_.shape[1:]))
    out[0::2] = a_
    out[1::2] = b_
    return out.movedim(0, axis)


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """Coarse node grid (Nyc, Nxc, B) -> fine (2*Nyc-1, 2*Nxc-1, B):
    linear interpolation respecting the right-diagonal triangulation
    (odd-odd nodes average the lower-left/upper-right coarse pair)."""
    ex = 0.5 * (e[:, :-1] + e[:, 1:])
    rows_even = _interleave(e, ex, axis=1)        # (Nyc, Nx, B)
    ey = 0.5 * (e[:-1, :] + e[1:, :])
    ed = 0.5 * (e[:-1, :-1] + e[1:, 1:])
    rows_odd = _interleave(ey, ed, axis=1)        # (Nyc-1, Nx, B)
    return _interleave(rows_even, rows_odd, axis=0)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Transpose of ``_prolong``: fine (Ny, Nx, B) -> coarse
    ((Ny+1)/2, (Nx+1)/2, B)."""
    rp = F.pad(r, (0, 0, 1, 1, 1, 1))
    c = rp[1:-1:2, 1:-1:2]
    return (c
            + 0.5 * (rp[1:-1:2, 0:-2:2] + rp[1:-1:2, 2::2]
                     + rp[0:-2:2, 1:-1:2] + rp[2::2, 1:-1:2]
                     + rp[0:-2:2, 0:-2:2] + rp[2::2, 2::2]))


@dataclasses.dataclass(frozen=True)
class MultigridPreconditioner:
    """Static V-cycle setup for one (grid, BC) pair; ``setup(alphas)``
    builds the per-sample level data, ``apply`` runs one symmetric
    V-cycle in ``dtype``."""

    grid: StructuredTriGrid
    num_levels: int
    nu_pre: int = 2
    nu_post: int = 2
    nu_coarse: int = 24
    omega: float = 0.8
    dtype: str = "float32"

    def __post_init__(self):
        check_precond_dtype(self.dtype)

    @classmethod
    def for_grid(cls, grid: StructuredTriGrid, min_size: int = 4, **kw):
        """Coarsen while both dims stay even and the min dim stays >=
        ``min_size`` (96^2 coarsens 96 -> 48 -> 24 -> 12 -> 6, 128x64 to
        8x4)."""
        levels = 1
        nx, ny = grid.nx, grid.ny
        while (nx % 2 == 0 and ny % 2 == 0
               and min(nx, ny) // 2 >= min_size):
            nx //= 2
            ny //= 2
            levels += 1
        return cls(grid=grid, num_levels=levels, **kw)

    @property
    def launches_per_cycle(self) -> int:
        """Kernel launches of one V-cycle on a card: on every level above
        the coarsest the pre-smoothing pair (and one a further pre-sweep),
        the residual with its restriction, the correction with the first
        post-sweep (and one a further post-sweep); one on the coarsest.
        4 (L - 1) + 1 at the default sweeps."""
        return (self.num_levels - 1) * (3 + max(self.nu_pre - 2, 0)
                                        + max(self.nu_post - 1, 0)) + 1

    def _level_static(self) -> List[Tuple[StencilOperator, np.ndarray]]:
        ops = []
        g = self.grid
        for _ in range(self.num_levels):
            mask = DirichletProfile(g).free_mask.reshape(
                g.ny + 1, g.nx + 1)[..., None]
            ops.append((StencilOperator(g), mask))
            g = StructuredTriGrid(g.nx // 2, g.ny // 2, g.lx, g.ly)
        return ops

    def setup(self, alphas: torch.Tensor):
        """alphas (B, n_cells) -> per-level (coefs, mask), coefs contiguous
        (7, Ny, Nx, B) batch-last, both in ``self.dtype``.  The smoother's
        ``mask / coefs[0]`` is formed from them where it is used."""
        statics = self._level_static()
        B = alphas.shape[0]
        dt = _DTYPES[self.dtype]
        a = statics[0][0].alpha_to_cellgrid(alphas)      # (B, ny, nx, 2)
        a = a.permute(1, 2, 3, 0)                        # (ny, nx, 2, B)
        levels = []
        for li, (op, mask_np) in enumerate(statics):
            coefs = op.coefficients(a.permute(3, 0, 1, 2).reshape(B, -1))
            coefs = coefs.permute(1, 2, 3, 0)
            mask = torch.as_tensor(mask_np, dtype=dt, device=alphas.device)
            levels.append((coefs.to(dt).contiguous(), mask))
            if li + 1 < len(statics):  # a coarser level follows
                a = _coarsen_alpha_cellgrid(a)
        return levels

    def apply(self, levels, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V-cycle: r (Ny, Nx, B) -> z ~ A^{-1} r, computed
        in ``self.dtype`` and returned in r's dtype."""
        out_dtype = r.dtype
        r = r.to(_DTYPES[self.dtype])
        omega, last = self.omega, len(levels) - 1

        def vcycle(li, r):
            coefs, mask = levels[li]
            if li == last:
                return vcycle_coarse(coefs, mask, r, omega, self.nu_coarse)
            z = vcycle_presmooth(coefs, mask, r, omega, min(self.nu_pre, 2))
            for _ in range(self.nu_pre - 2):
                z = vcycle_smooth(coefs, mask, r, z, omega)
            rc = vcycle_restrict(coefs, mask, r, z, levels[li + 1][1])
            with span(_LEVEL_SPANS[li + 1]):
                ec = vcycle(li + 1, rc)
            z = vcycle_correct(coefs, mask, r, z, ec, omega,
                               min(self.nu_post, 1))
            for _ in range(self.nu_post - 1):
                z = vcycle_smooth(coefs, mask, r, z, omega)
            return z

        with span(_LEVEL_SPANS[0]):
            z = vcycle(0, r.contiguous())
        return z.to(out_dtype)
