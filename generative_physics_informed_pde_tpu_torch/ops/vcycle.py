"""The multigrid V-cycle's steps, each one kernel on a card: the CUDA
kernels of ``csrc/vcycle.cuh`` (built into K1's library) and their plain
PyTorch versions.

On batch-last ``(Ny, Nx, B)`` arrays of one level -- coefficients ``coefs``
(7, Ny, Nx, B), the free-node ``mask`` (Ny, Nx, 1), the residual ``r`` --
with the damped-Jacobi sweep

    S(z) = z + w D^-1 (r - K z),   D^-1 = mask / where(coefs[0] <= 0, 1, coefs[0]),

``K z`` K1's masked apply (zero outside the grid), ``w = omega``:

* :func:`vcycle_presmooth`: ``sweeps`` (0-2) sweeps from zero; the first is
  ``w D^-1 r``, since ``K 0 = 0``;
* :func:`vcycle_restrict`: ``coarse_mask * R(mask * (r - K z))``, ``R`` the
  transpose of the prolongation (``fem.multigrid._restrict``);
* :func:`vcycle_correct`: ``sweeps`` (0 or 1) sweeps from
  ``z + mask * P(ec)``, ``P`` the prolongation (``fem.multigrid._prolong``);
* :func:`vcycle_smooth`: one sweep;
* :func:`vcycle_coarse`: ``sweeps`` sweeps from zero (the coarsest level).

They replace no TPU kernel: the JAX package's V-cycle is written in XLA
operations.  On a CUDA tensor each wrapper launches its kernel with the
geometry of :func:`vcycle_plan` or raises; on a CPU tensor it runs its plain
version, which is the V-cycle's written-out operations.  In bfloat16 the
plain versions (and the kernels) widen the inputs to float32, compute there
and round each output once.  Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .stencil import (_K1_DTYPE_SUFFIX, _LINE_BYTES, _THREADS, LaunchPlan,
                      _check, _sm_count, apply_stencil_reference)

_STEPS = {"presmooth": 0, "restrict": 1, "correct": 2, "smooth": 3,
          "coarse": 4}
# Output tile (rows, columns of nodes; restrict: coarse nodes, gathering
# from 2x as many fine ones) before halving for small grids.  A tile is
# staged with its halo in shared memory, 128 bytes a node: (8 + 2)^2 nodes,
# 12.8 KB; restrict (11^2 + 9^2) nodes, 25.9 KB.
_TILE = {"presmooth": (8, 8), "restrict": (4, 4), "correct": (8, 8),
         "smooth": (8, 8)}
_SHARED_BYTES = 48 * 1024   # csrc/vcycle.cuh kSharedBytes


def _acc_item(dtype: torch.dtype) -> int:
    """Bytes of the type the kernels sum in (bfloat16 sums in float32)."""
    return 8 if dtype == torch.float64 else 4


def _tiled(Ny, Nx, B, chunk, rows, cols) -> LaunchPlan:
    """Tiles of ``rows`` x ``cols`` nodes (at most the grid), chunks of
    ``chunk`` batch entries, one thread per entry and node up to 256."""
    rows, cols = min(rows, Ny), min(cols, Nx)
    threads = min(_THREADS, chunk << (rows * cols - 1).bit_length())
    tiles_y, tiles_x = -(-Ny // rows), -(-Nx // cols)
    return LaunchPlan(tiles_y, tiles_x, rows, cols, chunk, 1, threads,
                      tiles_y * tiles_x * -(-B // chunk))


@lru_cache(maxsize=None)
def vcycle_plan(step: str, Ny: int, Nx: int, B: int, dtype: torch.dtype,
                sm_count: int) -> LaunchPlan:
    """The geometry ``step`` is launched with on the level ``(Ny, Nx, B)``
    (the fine sizes; restrict's plan covers the coarse grid) on a card of
    ``sm_count`` SMs.  A chunk is 128 bytes of the summed type (fewer
    entries if B is smaller); loads are scalar, so alignment does not
    enter.  Tiles halve while the grid would have fewer than two blocks an
    SM.  The coarsest level takes the whole grid a block, its chunk halved
    while there are fewer than two blocks an SM or its two z buffers would
    not fit 48 KB (``vcycle_scratch`` says when they still do not).  Wide
    batches (B = 16,384) keep full chunks and tiles, narrow ones (B = 128)
    get smaller tiles and chunks: one computed function, nothing timed."""
    if step not in _STEPS:
        raise ValueError(f"no V-cycle step {step!r}")
    acc = _acc_item(dtype)
    chunk = min(_LINE_BYTES // acc, 1 << (B - 1).bit_length())
    if step == "coarse":
        while chunk > 1 and (-(-B // chunk) < 2 * sm_count
                             or 2 * Ny * Nx * chunk * acc > _SHARED_BYTES):
            chunk //= 2
        return _tiled(Ny, Nx, B, chunk, Ny, Nx)
    if step == "restrict":
        Ny, Nx = (Ny + 1) // 2, (Nx + 1) // 2
    rows, cols = _TILE[step]
    plan = _tiled(Ny, Nx, B, chunk, rows, cols)
    while plan.blocks < 2 * sm_count and rows * cols > 1:
        rows, cols = max(rows // 2, 1), max(cols // 2, 1)
        plan = _tiled(Ny, Nx, B, chunk, rows, cols)
    return plan


def vcycle_scratch(plan: LaunchPlan, dtype: torch.dtype) -> bool:
    """Whether the coarse step's two z buffers exceed 48 KB of shared
    memory at ``plan`` (then the wrapper passes a scratch array)."""
    return (2 * plan.tile_rows * plan.tile_cols * plan.chunk
            * _acc_item(dtype) > _SHARED_BYTES)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _wide(*xs):
    """bfloat16 tensors upcast to float32 (exact), others as they are."""
    return [x.float() if x.dtype == torch.bfloat16 else x for x in xs]


def _weight(coefs, mask, omega):
    """w D^-1 = omega * (mask / where(coefs[0] <= 0, 1, coefs[0]))."""
    diag = coefs[0]
    return omega * (mask / torch.where(diag <= 0, 1.0, diag))


def _sweep(coefs, mask, r, z, wd):
    return z + wd * (r - apply_stencil_reference(coefs, z, mask))


def vcycle_presmooth_reference(coefs, mask, r, omega: float,
                               sweeps: int = 2) -> torch.Tensor:
    """Plain version of :func:`vcycle_presmooth`."""
    c, m, rr = _wide(coefs, mask, r)
    wd = _weight(c, m, omega)
    z = wd * rr if sweeps else torch.zeros_like(rr)
    for _ in range(sweeps - 1):
        z = _sweep(c, m, rr, z, wd)
    return z.to(r.dtype)


def vcycle_restrict_reference(coefs, mask, r, z,
                              coarse_mask) -> torch.Tensor:
    """Plain version of :func:`vcycle_restrict`."""
    from ..fem.multigrid import _restrict

    c, m, rr, zz, cm = _wide(coefs, mask, r, z, coarse_mask)
    resid = m * (rr - apply_stencil_reference(c, zz, m))
    return (cm * _restrict(resid)).to(r.dtype).contiguous()


def vcycle_correct_reference(coefs, mask, r, z, ec, omega: float,
                             sweeps: int = 1) -> torch.Tensor:
    """Plain version of :func:`vcycle_correct`."""
    from ..fem.multigrid import _prolong

    c, m, rr, zz, e = _wide(coefs, mask, r, z, ec)
    zz = zz + m * _prolong(e)
    if sweeps:
        zz = _sweep(c, m, rr, zz, _weight(c, m, omega))
    return zz.to(r.dtype)


def vcycle_smooth_reference(coefs, mask, r, z, omega: float) -> torch.Tensor:
    """Plain version of :func:`vcycle_smooth`."""
    c, m, rr, zz = _wide(coefs, mask, r, z)
    return _sweep(c, m, rr, zz, _weight(c, m, omega)).to(r.dtype)


def vcycle_coarse_reference(coefs, mask, r, omega: float,
                            sweeps: int) -> torch.Tensor:
    """Plain version of :func:`vcycle_coarse`."""
    c, m, rr = _wide(coefs, mask, r)
    wd = _weight(c, m, omega)
    z = torch.zeros_like(rr)
    for _ in range(sweeps):
        z = _sweep(c, m, rr, z, wd)
    return z.to(r.dtype)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_FNS = {}


def _kernel(dtype):
    """``gpipde_vcycle_<dtype>`` of K1's library with its argument types
    set, resolved once per process."""
    symbol = f"gpipde_vcycle_{_K1_DTYPE_SUFFIX[dtype]}"
    fn = _FNS.get(symbol)
    if fn is None:
        from ._build import load_library

        fn = getattr(load_library("stencil"), symbol)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


_PLANS = {}


def _plain(t: torch.Tensor) -> bool:
    """Whether a step on ``t`` runs its plain version (a CPU tensor)."""
    return t.device.type == "cpu"


def _stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``; raises off a card."""
    if device.type != "cuda":
        raise ValueError(f"the V-cycle steps run on cuda or cpu, not "
                         f"{device}")
    return torch.cuda.current_stream(device).cuda_stream


def _launch(step, coefs, mask, r, z=None, aux=None, omega=0.0, sweeps=0):
    """Allocate the output and launch ``step`` on the current stream with
    ``vcycle_plan``'s geometry (looked up once per shape); raises on a
    refused launch."""
    device = r.device
    stream = _stream(device)
    Ny, Nx, B = r.shape
    out = torch.empty((aux.shape[0], aux.shape[1], B) if step == "restrict"
                      else (Ny, Nx, B), dtype=r.dtype, device=device)
    index = device.index
    key = (step, Ny, Nx, B, r.dtype, index)
    entry = _PLANS.get(key)
    if entry is None:
        plan = vcycle_plan(step, Ny, Nx, B, r.dtype, _sm_count(index))
        ints = plan.as_ints()
        entry = _PLANS[key] = ((ctypes.c_int * len(ints))(*ints),
                               step == "coarse"
                               and vcycle_scratch(plan, r.dtype))
    ints, needs_scratch = entry
    scratch = torch.empty((2, Ny, Nx, B), device=device,
                          dtype=torch.float64 if r.dtype == torch.float64
                          else torch.float32) if needs_scratch else None
    ptrs = [t.data_ptr() if t is not None else None
            for t in (coefs, mask, r, z, aux, out, scratch)]
    rc = _kernel(r.dtype)(_STEPS[step], *ptrs, Ny, Nx, B, float(omega),
                          int(sweeps), ints, index, stream)
    if rc != 0:
        raise RuntimeError(f"vcycle_{step} kernel launch failed with CUDA "
                           f"error {rc} at shape {(Ny, Nx, B)}")
    return out


def _check_level(coefs, mask, r, *fields):
    """K1's checks on (coefs, r, mask); each further (name, tensor, shape)
    of the same dtype and device, contiguous."""
    _check(coefs, r, mask, 7, _K1_DTYPE_SUFFIX)
    for name, t, shape in fields:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != r.dtype or t.device != r.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, not "
                            f"{r.dtype} on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _coarse_shape(r, last):
    Ny, Nx, B = r.shape
    if Ny % 2 == 0 or Nx % 2 == 0 or min(Ny, Nx) < 3:
        raise ValueError(f"a level with a coarser one has odd sizes >= 3, "
                         f"got {(Ny, Nx)}")
    return ((Ny + 1) // 2, (Nx + 1) // 2, last)


def _sweeps(sweeps, most):
    if not 0 <= sweeps <= most:
        raise ValueError(f"sweeps must be 0 to {most}, got {sweeps}")
    return sweeps


def vcycle_presmooth(coefs, mask, r, omega: float,
                     sweeps: int = 2) -> torch.Tensor:
    """``sweeps`` (0, 1 or 2) damped-Jacobi sweeps from zero: coefs (7, Ny,
    Nx, B), mask (Ny, Nx, 1), r (Ny, Nx, B) -> z (Ny, Nx, B)."""
    _check_level(coefs, mask, r)
    _sweeps(sweeps, 2)
    if _plain(r):
        return vcycle_presmooth_reference(coefs, mask, r, omega, sweeps)
    out = _launch("presmooth", coefs, mask, r, omega=omega, sweeps=sweeps)
    vcycle_presmooth.launches += 1
    return out


def vcycle_restrict(coefs, mask, r, z, coarse_mask) -> torch.Tensor:
    """The masked residual of z restricted to the coarser level: ->
    ((Ny+1)/2, (Nx+1)/2, B), times ``coarse_mask`` ((Ny+1)/2, (Nx+1)/2,
    1)."""
    cshape = _coarse_shape(r, 1)
    _check_level(coefs, mask, r, ("z", z, tuple(r.shape)),
                 ("coarse_mask", coarse_mask, cshape))
    if _plain(r):
        return vcycle_restrict_reference(coefs, mask, r, z, coarse_mask)
    out = _launch("restrict", coefs, mask, r, z, coarse_mask)
    vcycle_restrict.launches += 1
    return out


def vcycle_correct(coefs, mask, r, z, ec, omega: float,
                   sweeps: int = 1) -> torch.Tensor:
    """``z + mask * P(ec)`` (ec ((Ny+1)/2, (Nx+1)/2, B)) and ``sweeps`` (0
    or 1) sweeps from it -> (Ny, Nx, B)."""
    cshape = _coarse_shape(r, r.shape[2])
    _check_level(coefs, mask, r, ("z", z, tuple(r.shape)), ("ec", ec, cshape))
    _sweeps(sweeps, 1)
    if _plain(r):
        return vcycle_correct_reference(coefs, mask, r, z, ec, omega, sweeps)
    out = _launch("correct", coefs, mask, r, z, ec, omega, sweeps)
    vcycle_correct.launches += 1
    return out


def vcycle_smooth(coefs, mask, r, z, omega: float) -> torch.Tensor:
    """One damped-Jacobi sweep from z -> (Ny, Nx, B)."""
    _check_level(coefs, mask, r, ("z", z, tuple(r.shape)))
    if _plain(r):
        return vcycle_smooth_reference(coefs, mask, r, z, omega)
    out = _launch("smooth", coefs, mask, r, z, omega=omega, sweeps=1)
    vcycle_smooth.launches += 1
    return out


def vcycle_coarse(coefs, mask, r, omega: float, sweeps: int) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps from zero on the coarsest level, in
    one launch -> (Ny, Nx, B)."""
    _check_level(coefs, mask, r)
    _sweeps(sweeps, 2 ** 30)
    if _plain(r):
        return vcycle_coarse_reference(coefs, mask, r, omega, sweeps)
    out = _launch("coarse", coefs, mask, r, omega=omega, sweeps=sweeps)
    vcycle_coarse.launches += 1
    return out


for _f in (vcycle_presmooth, vcycle_restrict, vcycle_correct, vcycle_smooth,
           vcycle_coarse):
    _f.launches = 0
