"""Masked 7-point stiffness stencil apply: the CUDA kernel and its plain
PyTorch version.

    out[y, x, b] = mask[y, x] * sum_k coefs[k, y, x, b] * v[y+oy_k, x+ox_k, b]

on batch-last ``(Ny, Nx, B)`` arrays, zero outside the grid; the offsets
are ``fem.assembly._OFFSETS``.  This is the innermost operation of every
batched label solve: the PCG matvec and the rhs apply.

:func:`apply_stencil` replaces the TPU kernel
``generative_physics_informed_pde_tpu/ops/stencil.py`` ``apply_stencil``
(kernel body ``_make_kernel``).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/stencil.cu`` (built by ``ops/_build.py``)
or raises; on a CPU tensor it runs :func:`apply_stencil_reference`.  It
counts its kernel launches in ``apply_stencil.launches``.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_SYMBOLS = {torch.float32: "gpipde_apply_stencil_f32",
                   torch.float64: "gpipde_apply_stencil_f64"}


def apply_stencil_reference(coefs: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same sum order)."""
    from ..fem.batched_solver import _apply_stencil_blast

    return mask * _apply_stencil_blast(coefs, v)


def _check(coefs, v, mask):
    if coefs.dim() != 4 or coefs.shape[0] != 7:
        raise ValueError(f"coefs must be (7, Ny, Nx, B), got "
                         f"{tuple(coefs.shape)}")
    Ny, Nx, B = coefs.shape[1:]
    if tuple(v.shape) != (Ny, Nx, B):
        raise ValueError(f"v must be {(Ny, Nx, B)}, got {tuple(v.shape)}")
    if tuple(mask.shape) != (Ny, Nx, 1):
        raise ValueError(f"mask must be {(Ny, Nx, 1)}, got "
                         f"{tuple(mask.shape)}")
    if not (coefs.dtype == v.dtype == mask.dtype) \
            or v.dtype not in _KERNEL_SYMBOLS:
        raise TypeError("coefs, v and mask must share one dtype, float32 or "
                        f"float64; got {coefs.dtype}, {v.dtype}, {mask.dtype}")
    if not (coefs.device == v.device == mask.device):
        raise ValueError(f"coefs, v and mask lie on {coefs.device}, "
                         f"{v.device}, {mask.device}")
    if not (coefs.is_contiguous() and v.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("coefs, v and mask must be contiguous (make the "
                         "coefficients contiguous once per solve)")


def _kernel(dtype):
    from ._build import load_library

    fn = getattr(load_library("stencil"), _KERNEL_SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def apply_stencil(coefs: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked stencil apply: coefs (7, Ny, Nx, B), v (Ny, Nx, B),
    mask (Ny, Nx, 1) -> (Ny, Nx, B), all contiguous, one dtype."""
    _check(coefs, v, mask)
    if v.device.type == "cpu":
        return apply_stencil_reference(coefs, v, mask)
    if v.device.type != "cuda":
        raise ValueError(f"apply_stencil runs on cuda or cpu, not {v.device}")
    Ny, Nx, B = v.shape
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _kernel(v.dtype)(coefs.data_ptr(), v.data_ptr(), mask.data_ptr(),
                          out.data_ptr(), Ny, Nx, B, v.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"apply_stencil kernel launch failed with CUDA "
                           f"error {rc} at shape {(Ny, Nx, B)}")
    apply_stencil.launches += 1
    return out


apply_stencil.launches = 0
