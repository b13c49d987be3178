"""Effective-property map and the ROM operator with the embedded coarse
FEM solve.

Port of ``EffectivePropertyMap``, ``propagate_gp_samples``, ``ROM`` and
``ReducedOrderModelOperator`` (``forward_mean``, ``__call__`` and
``propagate_samples``) from
``generative_physics_informed_pde_tpu/models/components.py``.  The learnable
vectors (``logsigmas_X``, ``logsigmas_y``) are module parameters here
instead of entries of a separate parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..fem.solvers import rom_solve
from ..inference.likelihoods import reparametrize, standard_normal


class EffectivePropertyMap(nn.Module):
    """z -> coarse log-conductivity X_c ("gp").  ``num_hidden_layers == 0``
    is one affine map; otherwise an MLP with linearly decayed widths.
    With ``independent_X`` forward returns (mean, logsigmas)."""

    def __init__(self, latent_dim: int, dim_effective_property: int,
                 num_hidden_layers: int = 0, independent_X: bool = True):
        super().__init__()
        self.independent_X = independent_X
        widths = [latent_dim]
        if num_hidden_layers > 0:
            widths += [int(w) for w in np.linspace(
                latent_dim, dim_effective_property,
                num_hidden_layers + 2).astype(int)[1:-1]]
        widths.append(dim_effective_property)
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}",
                            nn.Linear(widths[i], widths[i + 1]))
        self.n_dense = len(widths) - 1
        if independent_X:
            self.logsigmas_X = nn.Parameter(
                torch.ones(dim_effective_property))

    def forward(self, z):
        x = z
        for i in range(self.n_dense):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_dense - 1:
                x = F.relu(x)
        if not self.independent_X:
            return x
        return x, self.logsigmas_X.to(x.dtype).expand_as(x)


def propagate_gp_samples(gp_out, generator=None):
    """Reparameterised sample through the effective-property map."""
    if isinstance(gp_out, tuple):
        mean, logsigmas = gp_out
        eps = standard_normal(logsigmas.shape, mean, generator)
        return mean + torch.exp(logsigmas) * eps
    return gp_out


class ROM(nn.Module):
    """The embedded coarse FEM solver: ``K = M . x`` with the Dirichlet
    dofs eliminated, solved densely (``fem.solvers.rom_solve``)."""

    def __init__(self, M: np.ndarray, bc_dofs: np.ndarray):
        super().__init__()
        self.register_buffer("M", torch.as_tensor(M))
        self.bc_dofs = np.asarray(bc_dofs)  # host numpy, as rom_solve needs

    @classmethod
    def from_physics(cls, physics, max_cells: int = 4096) -> "ROM":
        if physics.grid.n_cells > max_cells:
            raise ValueError("ROM exceeds intended maximum size")
        return cls(physics.assembly_tensor,
                   np.asarray(physics.constrained_dofs))

    @property
    def V_dim(self) -> int:
        return self.M.shape[0]

    @property
    def Vc_dim(self) -> int:
        return self.M.shape[2]

    def forward(self, X, F_):
        """X (..., c) positive conductivities, F (..., d) forces with the
        BC values applied -> (..., d) solutions."""
        return rom_solve(self.M.to(X.dtype), X, F_, self.bc_dofs)


class ReducedOrderModelOperator(nn.Module):
    """"g": y = W . rom(exp(X_c) + 1e-8, F) with a learnable per-dof noise
    ``logsigmas_y`` (init ones)."""

    EXP_FLOOR = 1e-8

    def __init__(self, rom: ROM, W: np.ndarray):
        super().__init__()
        W = np.asarray(W)
        if W.shape[0] < W.shape[1]:
            raise ValueError("W must be tall (fine dofs x rom dofs)")
        self.rom = rom
        self.register_buffer("W", torch.as_tensor(W))
        self.logsigmas_y = nn.Parameter(torch.ones(W.shape[0]))

    @classmethod
    def from_physics(cls, physics: dict) -> "ReducedOrderModelOperator":
        return cls(ROM.from_physics(physics["rom"]), physics["W"])

    @property
    def dim_effective_property(self) -> int:
        return self.rom.Vc_dim

    @property
    def dim_out(self) -> int:
        return self.W.shape[0]

    def forward_mean(self, effprop, F_):
        """(..., c) log-properties + (..., d_rom) forces -> (..., n_free)."""
        y_rom = self.rom(torch.exp(effprop) + self.EXP_FLOOR, F_)
        return torch.einsum("sk,...k->...s", self.W.to(effprop.dtype), y_rom)

    def forward(self, effprop, F_):
        mean = self.forward_mean(effprop, F_)
        return mean, self.logsigmas_y.to(mean.dtype).expand_as(mean)

    def propagate_samples(self, effprops, F_, generator=None):
        """Reparameterised push-through: one draw of y per row."""
        mean, logsigmas = self(effprops, F_)
        return reparametrize(generator, mean, logsigmas)
