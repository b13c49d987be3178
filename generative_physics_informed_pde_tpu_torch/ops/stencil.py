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
operation of every batched solve: the PCG matvec, the rhs apply and the
adjoint's ``K lambda``.

They replace the TPU kernels ``apply_stencil`` (body ``_make_kernel``) and
``apply_stencil_sym`` (body ``_make_sym_kernel``) of
``generative_physics_informed_pde_tpu/ops/stencil.py``.  On a CUDA tensor
each wrapper launches its hand-written kernel (built by ``ops/_build.py``)
or raises; on a CPU tensor it runs its plain version.  Each counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

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
