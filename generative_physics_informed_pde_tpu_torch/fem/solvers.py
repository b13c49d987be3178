"""Dense batched solves for the embedded coarse (ROM) FEM problem.

Port of ``stiffness_from_tensor`` and ``rom_solve`` from
``generative_physics_informed_pde_tpu/fem/solvers.py``: the symmetric
reduced system ``K_ff y_f = F_f - K_fc y_c`` through a batched Cholesky
factorisation (``K_ff`` is SPD for positive conductivities).
"""

from __future__ import annotations

import numpy as np
import torch


def stiffness_from_tensor(M: torch.Tensor, alpha: torch.Tensor,
                          bc_dofs) -> torch.Tensor:
    """Batched dense stiffness ``K = M . alpha`` with the Dirichlet rows
    replaced by identity rows.  M: (d, d, c), alpha: (..., c)."""
    K = torch.einsum("ijc,...c->...ij", M, alpha)
    d = K.shape[-1]
    row_is_bc = torch.zeros(d, dtype=torch.bool, device=K.device)
    row_is_bc[torch.as_tensor(np.asarray(bc_dofs), device=K.device)] = True
    eye = torch.eye(d, dtype=K.dtype, device=K.device)
    return torch.where(row_is_bc[:, None], eye, K)


def rom_solve(M: torch.Tensor, alpha: torch.Tensor, F: torch.Tensor,
              bc_dofs) -> torch.Tensor:
    """Batched coarse solve ``K(alpha) y = F``.

    alpha: (..., c) positive conductivities; F: (..., d) forces that carry
    the Dirichlet values at ``bc_dofs`` (host numpy, as the reference keeps
    them).  Returns (..., d).  A system whose Cholesky factorisation fails
    (not positive definite in the working precision) gives NaN, as
    ``jnp.linalg.cholesky`` does in the JAX package, instead of raising;
    ``cholesky_ex`` does not wait for the device.  The reference's TPU
    ``max_chunk`` batching is a TPU runtime workaround and is left out.
    """
    dt = torch.promote_types(torch.promote_types(M.dtype, alpha.dtype),
                             F.dtype)
    M, alpha, F = M.to(dt), alpha.to(dt), F.to(dt)
    bc = np.asarray(bc_dofs)
    d = F.shape[-1]
    free = np.setdiff1d(np.arange(d), bc)
    FREE = torch.as_tensor(free, device=F.device)
    BC = torch.as_tensor(bc, device=F.device)
    F = F.expand(alpha.shape[:-1] + (d,))
    K = torch.einsum("ijc,...c->...ij", M, alpha)
    Kff = K[..., FREE[:, None], FREE[None, :]]
    L, info = torch.linalg.cholesky_ex(Kff)
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    rhs = F[..., FREE]
    if len(bc):
        Kfc = K[..., FREE[:, None], BC[None, :]]
        rhs = rhs - torch.einsum("...ij,...j->...i", Kfc, F[..., BC])
    yf = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    out = F.clone() if len(bc) else torch.zeros_like(F)
    out[..., FREE] = yf
    return out
