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
each wrapper launches its hand-written kernel (built by ``ops/_build.py``,
with the geometry of :func:`launch_plan`) or raises; on a CPU tensor it
runs its plain version.  Each counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

_DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# K1 alone also has a bfloat16 kernel, which no path launches: the
# bf16 V-cycle runs in the steps of ``ops/vcycle.py``, whose symbols take
# their suffixes from this map too
_K1_DTYPE_SUFFIX = {**_DTYPE_SUFFIX, torch.bfloat16: "bf16"}


def apply_stencil_reference(coefs: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same sum order).  In bfloat16
    the kernel's contract: the inputs upcast to f32, the f32 sums and the
    mask product, rounded once to bfloat16."""
    from ..fem.batched_solver import _apply_stencil_blast

    if v.dtype == torch.bfloat16:
        c, u, m = coefs.float(), v.float(), mask.float()
        return (m * _apply_stencil_blast(c, u)).to(torch.bfloat16)
    return mask * _apply_stencil_blast(coefs, v)


def apply_stencil_sym_reference(coefs4: torch.Tensor, v: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the symmetric-form kernel (same sum
    order)."""
    from ..fem.batched_solver import _apply_stencil_sym_blast

    return mask * _apply_stencil_sym_blast(coefs4, v)


def _check(coefs, v, mask, n_grids, dtypes=_DTYPE_SUFFIX):
    if coefs.dim() != 4 or coefs.shape[0] != n_grids:
        raise ValueError(f"coefs must be ({n_grids}, Ny, Nx, B), got "
                         f"{tuple(coefs.shape)}")
    Ny, Nx, B = coefs.shape[1:]
    if tuple(v.shape) != (Ny, Nx, B):
        raise ValueError(f"v must be {(Ny, Nx, B)}, got {tuple(v.shape)}")
    if tuple(mask.shape) != (Ny, Nx, 1):
        raise ValueError(f"mask must be {(Ny, Nx, 1)}, got "
                         f"{tuple(mask.shape)}")
    if not (coefs.dtype == v.dtype == mask.dtype) or v.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"coefs, v and mask must share one dtype, {names}; "
                        f"got {coefs.dtype}, {v.dtype}, {mask.dtype}")
    if not (coefs.device == v.device == mask.device):
        raise ValueError(f"coefs, v and mask lie on {coefs.device}, "
                         f"{v.device}, {mask.device}")
    if not (coefs.is_contiguous() and v.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("coefs, v and mask must be contiguous (make the "
                         "coefficients contiguous once per solve)")


# ---------------------------------------------------------------------------
# Launch plan of K1, K2 and K3
# ---------------------------------------------------------------------------
#
# A block of K1, K2 or K3 owns a tile of nodes (K3: of the padded grid) for
# one chunk of the batch; a thread owns ``vec`` consecutive batch entries of
# one node at a time and loads the coefficients and v it needs itself (K2,
# K3: 16 bytes a load where the batch row allows; K1: scalars), the tile's
# threads sharing v's lines in L1.  The geometry is a function of the shape
# alone; the kernels read it from ``LaunchPlan.as_ints()``.

_LINE_BYTES = 128          # one L2 line of the batch
_THREADS = 256             # the kernels' __launch_bounds__


@dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one K1, K2 or K3 launch.

    Tile ``(ty, tx)`` covers node rows ``ty * tile_rows`` up to
    ``min((ty + 1) * tile_rows, Ny)``, columns likewise; chunk ``c`` covers
    batch entries ``c * chunk`` up to ``min((c + 1) * chunk, B)``.  The
    grid is ``(chunks, tiles_x, tiles_y)`` blocks, chunks fastest, so
    neighbouring blocks read neighbouring bytes.  ``vec`` is the batch
    entries per load and thread: ``16 // itemsize`` on the 16-byte path,
    1 on the scalar path.  The ``chunk // vec`` lanes of a node are a power
    of two that divides ``threads``; each thread sums every
    ``threads // lanes``-th node of its tile.  No shared memory is used."""

    tiles_y: int
    tiles_x: int
    tile_rows: int
    tile_cols: int
    chunk: int
    vec: int
    threads: int
    blocks: int

    @property
    def chunks(self) -> int:
        return self.blocks // (self.tiles_y * self.tiles_x)

    def as_ints(self):
        """The C entry points' plan argument, in this order."""
        return (self.tiles_y, self.tiles_x, self.tile_rows, self.tile_cols,
                self.chunk, self.vec, self.threads, self.blocks)


# Per form K1, K2: (tile side in nodes, chunk in 128-byte lines, 16-byte
# loads).  Chosen on an H100 (PERF.md): K1 reads each coefficient once, so
# its loads gain nothing from 16 bytes and lose threads, and its kernel
# loads scalars only; K2 reads its direction grids and v again from the
# tile's lines, so it takes 8 x 8 tiles and 16-byte loads where the batch
# row allows.  K3 is K2's body on the padded grid and takes K2's form: K2's
# geometry measured best or near it at every K3 shape.
_GEOMETRY = {"K1": (2, 4, False), "K2": (8, 1, True)}


@lru_cache(maxsize=None)
def launch_plan(Ny: int, Nx: int, B: int, dtype: torch.dtype, sm_count: int,
                sym: bool = False, aligned: bool = True) -> LaunchPlan:
    """The geometry K1 (``sym=False``) or K2 and K3 (``sym=True``; for K3
    ``Ny``, ``Nx`` are the padded sizes) is launched with on a card of
    ``sm_count`` SMs: the form's tile, halved while the grid would have
    fewer than two blocks an SM (the coarse V-cycle levels are bound by
    latency).  ``aligned``: every data pointer is 16-byte
    aligned (torch allocations are); the 16-byte path also needs the batch
    row ``B * itemsize`` to be a multiple of 16 bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    tile, lines, vec16 = _GEOMETRY["K2" if sym else "K1"]
    plan = _plan(Ny, Nx, B, item, aligned, tile, lines, vec16)
    while plan.blocks < 2 * sm_count and tile > 1:
        tile //= 2
        plan = _plan(Ny, Nx, B, item, aligned, tile, lines, vec16)
    return plan


def _plan(Ny, Nx, B, item, aligned, tile, lines, vec16):
    """The plan for tiles of ``tile`` x ``tile`` nodes (at most the
    grid), chunks of ``lines`` 128-byte lines (fewer if B is smaller),
    16-byte loads if ``vec16`` and the shape allow them, and one thread
    per lane and node of a tile, at most 256 (at least one per lane)."""
    vec = 16 // item if vec16 and aligned and (B * item) % 16 == 0 else 1
    chunk = min(lines * _LINE_BYTES // item,
                max(vec, 1 << (B - 1).bit_length()))
    lanes = chunk // vec
    rows, cols = min(tile, Ny), min(tile, Nx)
    threads = max(lanes, min(_THREADS,
                             lanes << (rows * cols - 1).bit_length()))
    tiles_y, tiles_x = -(-Ny // rows), -(-Nx // cols)
    return LaunchPlan(tiles_y, tiles_x, rows, cols, chunk, vec, threads,
                      tiles_y * tiles_x * -(-B // chunk))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_FNS = {}


def _kernel(library, symbol):
    """``symbol`` of ``library`` with its argument types set, resolved once
    per process: four data pointers, Ny, Nx, B, the plan, the device index
    and the stream."""
    fn = _FNS.get(symbol)
    if fn is None:
        from ._build import load_library

        fn = getattr(load_library(library), symbol)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


_PLANS = {}


def _launch(name, library, coefs, v, mask, sym):
    """Allocate the output and launch ``gpipde_<name>_<dtype>`` of
    ``library`` on the current stream with ``launch_plan``'s geometry for
    these tensors (looked up once per shape and alignment); raises on a
    refused launch."""
    device = v.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    Ny, Nx, B = v.shape
    out = torch.empty_like(v)
    index = device.index
    stream = torch.cuda.current_stream(device).cuda_stream
    symbol = f"gpipde_{name}_{_K1_DTYPE_SUFFIX[v.dtype]}"
    ptrs = (coefs.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[3]) % 16 == 0
    key = (Ny, Nx, B, v.dtype, index, sym, aligned)
    ints = _PLANS.get(key)
    if ints is None:
        plan = launch_plan(Ny, Nx, B, v.dtype, _sm_count(index), sym,
                           aligned).as_ints()
        ints = _PLANS[key] = (ctypes.c_int * len(plan))(*plan)
    rc = _kernel(library, symbol)(*ptrs, Ny, Nx, B, ints, index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} at shape {(Ny, Nx, B)}")
    return out


def apply_stencil(coefs: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked stencil apply: coefs (7, Ny, Nx, B), v (Ny, Nx, B),
    mask (Ny, Nx, 1) -> (Ny, Nx, B), all contiguous, one dtype: float32,
    float64 or bfloat16 (summed in f32, rounded once)."""
    _check(coefs, v, mask, 7, _K1_DTYPE_SUFFIX)
    if v.device.type == "cpu":
        return apply_stencil_reference(coefs, v, mask)
    out = _launch("apply_stencil", "stencil", coefs, v, mask, sym=False)
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
    out = _launch("apply_stencil_sym", "stencil_sym", coefs4, v, mask,
                  sym=True)
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
                  v, mask, sym=True)
    apply_stencil_sym_blocked.launches += 1
    return out


apply_stencil_sym_blocked.launches = 0
