"""Sparse-format conversions.

Port of ``generative_physics_informed_pde_tpu/utils/conversions.py``:
scipy sparse -> ``torch.sparse_coo_tensor`` (the JAX package's BCOO) and
dense.  The solvers never form sparse matrices (their operators are
matrix-free stencils); the converters serve users with scipy pipelines.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def convert_scipy_sparse_to_sparse_coo(A, dtype=None,
                                       device="cuda") -> torch.Tensor:
    """scipy.sparse matrix -> coalesced ``torch.sparse_coo_tensor`` on
    ``device``."""
    coo = A.tocoo()
    indices = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
    values = torch.as_tensor(coo.data, dtype=dtype)
    return torch.sparse_coo_tensor(indices, values, coo.shape,
                                   device=resolve_device(device),
                                   check_invariants=True).coalesce()


def convert_scipy_sparse_to_dense(A, dtype=None,
                                  device="cuda") -> torch.Tensor:
    """scipy.sparse matrix -> dense tensor on ``device``."""
    return torch.as_tensor(np.asarray(A.todense()), dtype=dtype,
                           device=resolve_device(device))
