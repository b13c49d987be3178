"""Stand-alone calibration utilities for the ROM operator.

Port of ``generative_physics_informed_pde_tpu/models/calibration.py``:

* ``optimize_effective_properties`` fits per-sample coarse
  log-properties to labeled solutions by Adam (``torch.optim.Adam``) on
  the MSE through the differentiable ROM;
* ``reduced_order_model_solve`` is the Galerkin-projected ROM oracle
  ``y = W (W^T K W)^{-1} W^T f`` on the fine system, host float64.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..fem.assembly import dense_stiffness
from ..inference.likelihoods import relative_error_batched


def optimize_effective_properties(
        g, Y: torch.Tensor, F_ROM_BC: torch.Tensor,
        num_iterations: int = 300, lr: float = 1e-2,
        y_preprocessor: Optional[Callable] = None,
        verbose: bool = False) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """Fit ``logX`` (N, dim_effective_property), from zero, so that
    ``g.forward_mean(logX, F_ROM_BC) ~ Y`` in the mean squared error,
    with Adam at ``lr``.  ``g`` is a ``ReducedOrderModelOperator`` on the
    device of ``Y``; the JAX package's ``g_params`` argument is dropped,
    because the port's ``g`` owns its parameters (and ``forward_mean``
    reads none of them).  Returns (logX, Y_predict, objective), the
    objective one float per iteration, read from the device once at the
    end."""
    pre = y_preprocessor or (lambda y: y)
    Yp = pre(Y)
    logX = torch.zeros((Y.shape[0], g.dim_effective_property),
                       dtype=Y.dtype, device=Y.device, requires_grad=True)
    opt = torch.optim.Adam([logX], lr=lr)
    values = []
    for n in range(num_iterations):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((pre(g.forward_mean(logX, F_ROM_BC)) - Yp) ** 2)
        loss.backward()
        opt.step()
        values.append(loss.detach())
        if verbose and n % 100 == 0 and n > 0:
            with torch.no_grad():
                relerr = relative_error_batched(
                    g.forward_mean(logX, F_ROM_BC), Y)
            print(f"Iteration {n} || RelErr : {float(relerr)}")
    objective = (torch.stack(values).cpu().tolist() if values else [])
    with torch.no_grad():
        logX = logX.detach()
        Y_pred = g.forward_mean(logX, F_ROM_BC)
    return logX, Y_pred, objective


def reduced_order_model_solve(physics_fom, W: np.ndarray, X_DG: np.ndarray,
                              bc_values: np.ndarray) -> np.ndarray:
    """Galerkin-projected fine-system solves, per sample ``K_rom = W^T
    K_ff W`` and ``y = W K_rom^{-1} W^T f_eff``: X_DG (N, n_cells)
    log-conductivities, bc_values (N, n_constrained) -> (N, n_free), host
    float64 (an oracle)."""
    if not W.shape[0] > W.shape[1]:
        raise ValueError("W must be tall (fine dofs x rom dofs)")
    free = physics_fom.free_dofs
    con = physics_fom.constrained_dofs
    N = X_DG.shape[0]
    Y_rom = np.zeros((N, free.size))
    for n in range(N):
        K = dense_stiffness(physics_fom.grid, np.exp(np.asarray(X_DG[n])))
        K_ff = K[np.ix_(free, free)]
        f_eff = -K[np.ix_(free, con)] @ np.asarray(bc_values[n])
        K_rom = W.T @ K_ff @ W
        Y_rom[n] = W @ np.linalg.solve(K_rom, W.T @ f_eff)
    return Y_rom
