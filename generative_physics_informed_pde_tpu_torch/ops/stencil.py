"""Masked stiffness stencil applies: the CUDA kernels and their plain
PyTorch versions.

7-grid form (:func:`apply_stencil`, kernel ``csrc/stencil.cu``):

    out[y, x, b] = mask[y, x] * sum_k coefs[k, y, x, b] * v[y+oy_k, x+ox_k, b]

symmetric 4-grid form (:func:`apply_stencil_sym`, ``csrc/stencil_sym.cu``),
with ``coefs4 = [c0, c_N, c_E, c_D]`` from ``coefficients_sym``:

    out[y, x, b] = mask[y, x] * (c0 v + sum_dir c_dir[y, x] v[(y, x)+dir]
                                       + c_dir[(y, x)-dir] v[(y, x)-dir])

on batch-last ``(Ny, Nx, B)`` arrays, zero outside the grid; the offsets
are ``fem.assembly._OFFSETS`` and ``_SYM_DIRS``.  This is the innermost
operation of every batched solve: the PCG matvec, the rhs apply, the
adjoint's ``K lambda`` and the multigrid V-cycle's smoother and residual.

Halo-padded symmetric form (:func:`apply_stencil_sym_blocked`,
``csrc/stencil_sym_blocked.cu``): the same operator with the JAX blocked
kernel's contract -- vectors halo-padded to ``(Ny+2, Nx+2, B)`` with the
interior at ``[1:1+Ny, 1:1+Nx]`` and a zero halo, coefficients padded once
by :func:`pad_coefs_blocked`, the input masked by the kernel itself, so

    out = mask * K_sym * (mask * v),     halo of out = 0.

They replace the TPU kernels ``apply_stencil`` (body ``_make_kernel``),
``apply_stencil_sym`` (body ``_make_sym_kernel``) and
``apply_stencil_sym_blocked`` (body ``_make_sym_blocked_kernel``) of
``generative_physics_informed_pde_tpu/ops/stencil.py``.  On a CUDA tensor
each wrapper launches its hand-written kernel (built by ``ops/_build.py``)
or raises; on a CPU tensor it runs its plain version.  Each counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def apply_stencil_reference(coefs: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same sum order)."""
    from ..fem.batched_solver import _apply_stencil_blast

    return mask * _apply_stencil_blast(coefs, v)


def apply_stencil_sym_reference(coefs4: torch.Tensor, v: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the symmetric-form kernel (same sum
    order)."""
    from ..fem.batched_solver import _apply_stencil_sym_blast

    return mask * _apply_stencil_sym_blast(coefs4, v)


def _check(coefs, v, mask, n_grids):
    if coefs.dim() != 4 or coefs.shape[0] != n_grids:
        raise ValueError(f"coefs must be ({n_grids}, Ny, Nx, B), got "
                         f"{tuple(coefs.shape)}")
    Ny, Nx, B = coefs.shape[1:]
    if tuple(v.shape) != (Ny, Nx, B):
        raise ValueError(f"v must be {(Ny, Nx, B)}, got {tuple(v.shape)}")
    if tuple(mask.shape) != (Ny, Nx, 1):
        raise ValueError(f"mask must be {(Ny, Nx, 1)}, got "
                         f"{tuple(mask.shape)}")
    if not (coefs.dtype == v.dtype == mask.dtype) \
            or v.dtype not in _DTYPE_SUFFIX:
        raise TypeError("coefs, v and mask must share one dtype, float32 or "
                        f"float64; got {coefs.dtype}, {v.dtype}, {mask.dtype}")
    if not (coefs.device == v.device == mask.device):
        raise ValueError(f"coefs, v and mask lie on {coefs.device}, "
                         f"{v.device}, {mask.device}")
    if not (coefs.is_contiguous() and v.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("coefs, v and mask must be contiguous (make the "
                         "coefficients contiguous once per solve)")


def _kernel(library, symbol):
    from ._build import load_library

    fn = getattr(load_library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, library, coefs, v, mask):
    """Allocate the output and launch ``gpipde_<name>_<dtype>`` of
    ``library`` on the current stream; raises on a refused launch."""
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {v.device}")
    Ny, Nx, B = v.shape
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    fn = _kernel(library, f"gpipde_{name}_{_DTYPE_SUFFIX[v.dtype]}")
    rc = fn(coefs.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            Ny, Nx, B, v.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} at shape {(Ny, Nx, B)}")
    return out


def apply_stencil(coefs: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked stencil apply: coefs (7, Ny, Nx, B), v (Ny, Nx, B),
    mask (Ny, Nx, 1) -> (Ny, Nx, B), all contiguous, one dtype."""
    _check(coefs, v, mask, 7)
    if v.device.type == "cpu":
        return apply_stencil_reference(coefs, v, mask)
    out = _launch("apply_stencil", "stencil", coefs, v, mask)
    apply_stencil.launches += 1
    return out


apply_stencil.launches = 0


def apply_stencil_sym(coefs4: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Masked symmetric-form stencil apply: coefs4 (4, Ny, Nx, B) =
    [c0, c_N, c_E, c_D], v (Ny, Nx, B), mask (Ny, Nx, 1) -> (Ny, Nx, B),
    all contiguous, one dtype."""
    _check(coefs4, v, mask, 4)
    if v.device.type == "cpu":
        return apply_stencil_sym_reference(coefs4, v, mask)
    out = _launch("apply_stencil_sym", "stencil_sym", coefs4, v, mask)
    apply_stencil_sym.launches += 1
    return out


apply_stencil_sym.launches = 0


# ---------------------------------------------------------------------------
# Halo-padded symmetric form (the JAX package's blocked layout)
# ---------------------------------------------------------------------------
#
# The TPU layout (Bb, R, CP, 128) -- 128-lane batch blocks, rows padded to a
# multiple of the VMEM tile height, columns to a multiple of 8 -- is TPU
# tiling.  Here the layout is batch-last and padded by one halo row and
# column on each side: (Ny+2, Nx+2, B).  The zero halo replaces K2's edge
# guards.  ``choose_tile_rows`` is not ported: it sizes VMEM tiles, and
# these helpers take no tile height.


def pad_blocked(x: torch.Tensor, Ny: int, Nx: int) -> torch.Tensor:
    """(B, Ny, Nx) -> contiguous (Ny+2, Nx+2, B) with a zero halo."""
    B = x.shape[0]
    x = torch.nn.functional.pad(x.reshape(B, Ny, Nx), (1, 1, 1, 1))
    return x.permute(1, 2, 0).contiguous()


def unpad_blocked(xb: torch.Tensor, B: int, Ny: int, Nx: int) -> torch.Tensor:
    """(Ny+2, Nx+2, B) -> (B, Ny, Nx)."""
    return xb[1:1 + Ny, 1:1 + Nx, :B].permute(2, 0, 1)


def pad_coefs_blocked(coefs4: torch.Tensor, Ny: int, Nx: int) -> torch.Tensor:
    """(B, 4, Ny, Nx) symmetric stencil coefficients -> contiguous
    (4, Ny+2, Nx+2, B), zero outside the interior.  Done once per solve."""
    c = torch.nn.functional.pad(coefs4, (1, 1, 1, 1))
    return c.permute(1, 2, 3, 0).contiguous()


def mask_blocked(free_mask_2d: np.ndarray) -> np.ndarray:
    """(Ny, Nx) free-dof mask -> (Ny+2, Nx+2, 1), zero on the halo."""
    Ny, Nx = free_mask_2d.shape
    m = np.zeros((Ny + 2, Nx + 2, 1), dtype=free_mask_2d.dtype)
    m[1:1 + Ny, 1:1 + Nx, 0] = free_mask_2d
    return m


def apply_stencil_sym_blocked_reference(c_halo: torch.Tensor, v: torch.Tensor,
                                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the halo-padded kernel: the sum of
    ``_apply_stencil_sym_blast`` (c0 v, then per direction the +dir and the
    -dir term) on the masked input, masked again, zero on the halo."""
    from ..fem.assembly import _SYM_DIRS

    R, C = v.shape[0], v.shape[1]
    vm = v * mask
    inner = (slice(1, R - 1), slice(1, C - 1))
    acc = c_halo[0][inner] * vm[inner]
    for k, (oy, ox) in enumerate(_SYM_DIRS):
        c = c_halo[1 + k]
        acc = acc + c[inner] * vm[1 + oy:R - 1 + oy, 1 + ox:C - 1 + ox]
        acc = acc + (c[1 - oy:R - 1 - oy, 1 - ox:C - 1 - ox]
                     * vm[1 - oy:R - 1 - oy, 1 - ox:C - 1 - ox])
    out = torch.zeros_like(v)
    out[inner] = mask[inner] * acc
    return out


def apply_stencil_sym_blocked(c_halo: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Masked symmetric stencil apply on the halo-padded layout: c_halo
    (4, Ny+2, Nx+2, B) from :func:`pad_coefs_blocked`, v (Ny+2, Nx+2, B),
    mask (Ny+2, Nx+2, 1) zero on the halo -> (Ny+2, Nx+2, B) =
    ``mask * K_sym * (mask * v)`` with a zero halo; all contiguous, one
    dtype."""
    _check(c_halo, v, mask, 4)
    if min(v.shape[0], v.shape[1]) < 3:
        raise ValueError(f"a halo-padded grid is at least 3 x 3, got "
                         f"{tuple(v.shape[:2])}")
    if v.device.type == "cpu":
        return apply_stencil_sym_blocked_reference(c_halo, v, mask)
    out = _launch("apply_stencil_sym_blocked", "stencil_sym_blocked", c_halo,
                  v, mask)
    apply_stencil_sym_blocked.launches += 1
    return out


apply_stencil_sym_blocked.launches = 0
