"""The V-cycle's fused steps (``ops/vcycle.py``, kernels in
``ops/csrc/vcycle.cuh``) on the CPU.

* Each step's plain version equals the written-out operations it replaces
  (K1's plain apply and the elementwise sweep, ``_restrict``,
  ``_prolong``; the inverse diagonal formed from the level's
  coefficients) on every level of 64^2 and 128^2 at B = 1, 3, 128: float64
  and float32 value for value, bfloat16 within 4 bf16 ulps of the max (the
  written-out form rounds every operation, the fused steps once an
  output).
* One whole V-cycle equals the JAX package's: float64 to 1e-12 of the max
  (``F64_VCYCLE_RTOL``), float32 to 1e-5 (XLA sums in another order),
  bfloat16 to 4 bf16 ulps (``VCYCLE_RTOL``).
* On the kernel path (the library stubbed by one whose entry point runs the
  plain versions on the pointers it is given), a V-cycle makes
  ``4 (L - 1) + 1`` launches and no K1 launch, and equals the plain
  V-cycle bit for bit.
* The launch plan is a pure function of the shape (no clock is read) that
  covers every output, fits 48 KB of shared memory and 256 threads.
* K1's library key follows the new header.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import ctypes
import itertools
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.fem import multigrid as jmg
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem import multigrid as tmg
from generative_physics_informed_pde_tpu_torch.ops import _build, stencil
from generative_physics_informed_pde_tpu_torch.ops import vcycle
from generative_physics_informed_pde_tpu_torch.ops.stencil import (
    apply_stencil_reference)

BF16_ULP = 2.0 ** -7
VCYCLE_RTOL = 4 * BF16_ULP
F64_VCYCLE_RTOL = 1e-12
F32_VCYCLE_RTOL = 1e-5
OMEGA = 0.8
STEPS = ("presmooth", "restrict", "correct", "smooth", "coarse")
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _levels(n, B, dtype, seed):
    """The V-cycle's levels of an n^2 'ND' grid for B lognormal fields, a
    masked residual and a z per level, and a correction per coarser
    level, in ``dtype``."""
    grid = tfem.StructuredTriGrid(n, n)
    mg = tmg.MultigridPreconditioner.for_grid(grid, dtype=dtype)
    rng = np.random.default_rng(seed)
    alphas = torch.as_tensor(np.exp(rng.normal(0, 1.0, (B, grid.n_cells))))
    levels = mg.setup(alphas)
    dt = DTYPES[dtype]
    rz = [tuple(torch.as_tensor(rng.normal(size=(m.shape[0], m.shape[1], B)),
                                dtype=dt) * m for _ in range(2))
          for _, m in levels]
    return mg, levels, rz


def _written_out(step, coefs, mask, r, z, aux, nu_coarse):
    """The V-cycle's written-out operations, in the level's dtype."""
    inv_diag = mask / torch.where(coefs[0] <= 0, 1.0, coefs[0])

    def smooth(z, nu):
        for _ in range(nu):
            z = z + OMEGA * inv_diag * (r - apply_stencil_reference(
                coefs, z, mask))
        return z

    if step == "presmooth":
        return smooth(torch.zeros_like(r), 2)
    if step == "restrict":
        resid = mask * (r - apply_stencil_reference(coefs, z, mask))
        return aux * tmg._restrict(resid)
    if step == "correct":
        return smooth(z + mask * tmg._prolong(aux), 1)
    if step == "smooth":
        return smooth(z, 1)
    return smooth(torch.zeros_like(r), nu_coarse)


def _step(step, coefs, mask, r, z, aux, nu_coarse):
    fn = getattr(vcycle, f"vcycle_{step}")
    if step == "presmooth":
        return fn(coefs, mask, r, OMEGA, 2)
    if step == "restrict":
        return fn(coefs, mask, r, z, aux)
    if step == "correct":
        return fn(coefs, mask, r, z, aux, OMEGA, 1)
    if step == "smooth":
        return fn(coefs, mask, r, z, OMEGA)
    return fn(coefs, mask, r, OMEGA, nu_coarse)


def _cases(mg, levels, rz):
    """(step, level, its tensors, aux) of every step on every level it
    runs on: the coarse step on the coarsest, the others above it."""
    last = len(levels) - 1
    for li, ((coefs, mask), (r, z)) in enumerate(zip(levels, rz)):
        if li == last:
            yield "coarse", li, coefs, mask, r, z, None
            continue
        for step in STEPS[:-1]:
            aux = (levels[li + 1][1] if step == "restrict"
                   else rz[li + 1][1] if step == "correct" else None)
            yield step, li, coefs, mask, r, z, aux


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the caller's count restored after
    it: later tests in the same process sum in their own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_steps_equal_the_written_out_operations(dtype, n, B,
                                                       one_thread):
    mg, levels, rz = _levels(n, B, dtype, seed=n + B)
    assert mg.num_levels == {64: 5, 128: 6}[n]
    seen = set()
    for step, li, coefs, mask, r, z, aux in _cases(mg, levels, rz):
        got = _step(step, coefs, mask, r, z, aux, mg.nu_coarse)
        want = _written_out(step, coefs, mask, r, z, aux, mg.nu_coarse)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.is_contiguous()
        where = f"{step} on level {li} ({tuple(r.shape)}, {dtype})"
        if dtype == "bfloat16":
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= VCYCLE_RTOL * scale, (where, err / scale)
        else:
            assert torch.equal(got, want), where
        seen.add(step)
    assert seen == set(STEPS)


def _jax_pair(n, dtype):
    return (jmg.MultigridPreconditioner.for_grid(
                jfem.StructuredTriGrid(n, n), dtype=dtype),
            tmg.MultigridPreconditioner.for_grid(
                tfem.StructuredTriGrid(n, n), dtype=dtype))


@pytest.mark.parametrize("dtype,rtol", [("float64", F64_VCYCLE_RTOL),
                                        ("float32", F32_VCYCLE_RTOL),
                                        ("bfloat16", VCYCLE_RTOL)])
def test_vcycle_matches_jax(dtype, rtol):
    n, B = 64, 3
    jm, tm = _jax_pair(n, dtype)
    rng = np.random.default_rng(23)
    data = np.float64 if dtype == "float64" else np.float32
    alphas = np.exp(rng.normal(0, 1.0, (B, n * n * 2))).astype(data)
    mask = tfem.DirichletProfile(tm.grid).free_mask.reshape(n + 1, n + 1, 1)
    r = (rng.normal(size=(n + 1, n + 1, B)) * mask).astype(data)
    zj = np.asarray(jax.jit(lambda a, r: jm.apply(jm.setup(a), r))(
        jnp.asarray(alphas), jnp.asarray(r)))
    zt = tm.apply(tm.setup(torch.as_tensor(alphas)), torch.as_tensor(r))
    assert zt.dtype == torch.as_tensor(r).dtype
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0,
                               atol=rtol * np.abs(zj).max())


_CTYPE = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float,
          torch.bfloat16: ctypes.c_uint16}
_SUFFIX = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}


class _PlainLibrary:
    """K1's library as the wrappers see it, with an entry point per dtype
    that runs the step's plain version on the tensors behind the pointers
    it is given; records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, symbol):
        dtype = _SUFFIX[symbol.rsplit("_", 1)[1]]

        def view(ptr, shape, dt=dtype):
            n = int(np.prod(shape))
            buf = (_CTYPE[dt] * n).from_address(ptr)
            return torch.frombuffer(buf, dtype=dt).view(shape)

        def entry(step, coefs, mask, r, z, aux, out, scratch, Ny, Nx, B,
                  omega, sweeps, plan, device, stream):
            name = {v: k for k, v in vcycle._STEPS.items()}[step]
            self.calls.append((symbol, name, (Ny, Nx, B), tuple(plan)))
            c = view(coefs, (7, Ny, Nx, B))
            m, rr = view(mask, (Ny, Nx, 1)), view(r, (Ny, Nx, B))
            cs = ((Ny + 1) // 2, (Nx + 1) // 2)
            if name == "presmooth":
                got = vcycle.vcycle_presmooth_reference(c, m, rr, omega,
                                                        sweeps)
                shape = (Ny, Nx, B)
            elif name == "restrict":
                got = vcycle.vcycle_restrict_reference(
                    c, m, rr, view(z, (Ny, Nx, B)), view(aux, (*cs, 1)))
                shape = (*cs, B)
            elif name == "correct":
                got = vcycle.vcycle_correct_reference(
                    c, m, rr, view(z, (Ny, Nx, B)), view(aux, (*cs, B)),
                    omega, sweeps)
                shape = (Ny, Nx, B)
            elif name == "smooth":
                got = vcycle.vcycle_smooth_reference(
                    c, m, rr, view(z, (Ny, Nx, B)), omega)
                shape = (Ny, Nx, B)
            else:
                got = vcycle.vcycle_coarse_reference(c, m, rr, omega,
                                                     sweeps)
                shape = (Ny, Nx, B)
            view(out, shape).copy_(got)
            return 0

        return entry


@pytest.mark.parametrize("n,dtype", [(64, "float32"), (128, "float64"),
                                     (32, "bfloat16")])
def test_kernel_path_launches_four_a_level_and_no_k1(n, dtype, monkeypatch):
    lib = _PlainLibrary()
    monkeypatch.setattr(_build, "load_library", lambda name: (
        lib if name == "stencil" else pytest.fail(f"loaded {name}")))
    monkeypatch.setattr(vcycle, "_FNS", {})
    monkeypatch.setattr(vcycle, "_PLANS", {})
    monkeypatch.setattr(vcycle, "_sm_count", lambda index: 132)
    monkeypatch.setattr(vcycle, "_stream", lambda device: 0)

    def k1(*args, **kw):
        raise AssertionError("the V-cycle launched K1")

    monkeypatch.setattr(stencil, "_launch", k1)
    B = 5
    mg, levels, rz = _levels(n, B, dtype, seed=1)
    r = rz[0][0]
    plain = mg.apply(levels, r)
    before = {s: getattr(vcycle, f"vcycle_{s}").launches for s in STEPS}
    monkeypatch.setattr(vcycle, "_plain", lambda t: False)
    got = mg.apply(levels, r)
    launched = {s: getattr(vcycle, f"vcycle_{s}").launches - before[s]
                for s in STEPS}
    L = mg.num_levels
    assert mg.launches_per_cycle == 4 * (L - 1) + 1 == len(lib.calls)
    assert launched == {"presmooth": L - 1, "restrict": L - 1,
                        "correct": L - 1, "smooth": L - 1, "coarse": 1}
    suffix = stencil._K1_DTYPE_SUFFIX[DTYPES[dtype]]
    assert {c[0] for c in lib.calls} == {f"gpipde_vcycle_{suffix}"}
    for symbol, step, (Ny, Nx, Bc), plan in lib.calls:
        assert Bc == B
        assert plan == vcycle.vcycle_plan(step, Ny, Nx, B, DTYPES[dtype],
                                          132).as_ints()
    assert torch.equal(got, plain)


def test_nondefault_sweeps_launch_one_more_step_each(monkeypatch):
    """nu_pre = nu_post = 3 add a smoothing launch per extra sweep; 1 and
    0 take the steps' one- and no-sweep forms; each equals the JAX
    package's V-cycle with those sweeps."""
    grid = tfem.StructuredTriGrid(32, 32)
    rng = np.random.default_rng(4)
    alphas = torch.as_tensor(np.exp(rng.normal(0, 1.0, (3, grid.n_cells))))
    mask = tfem.DirichletProfile(grid).free_mask.reshape(33, 33, 1)
    r = torch.as_tensor(rng.normal(size=(33, 33, 3)) * mask)
    for nu in (0, 1, 3):
        mg = tmg.MultigridPreconditioner.for_grid(
            grid, nu_pre=nu, nu_post=nu, dtype="float64")
        jm = jmg.MultigridPreconditioner.for_grid(
            jfem.StructuredTriGrid(32, 32), nu_pre=nu, nu_post=nu,
            dtype="float64")
        assert mg.launches_per_cycle == (mg.num_levels - 1) * (
            3 + max(nu - 2, 0) + max(nu - 1, 0)) + 1
        zj = np.asarray(jm.apply(jm.setup(jnp.asarray(alphas.numpy())),
                                 jnp.asarray(r.numpy())))
        zt = mg.apply(mg.setup(alphas), r).numpy()
        np.testing.assert_allclose(zt, zj, rtol=0,
                                   atol=F64_VCYCLE_RTOL * np.abs(zj).max())


def _plan_shapes():
    for n in (65, 33, 17, 9, 5, 129, 257, 513, 3):
        yield n, n
    yield from ((9, 5), (17, 33), (7, 13))


@pytest.mark.parametrize("dtype", list(DTYPES.values()))
def test_plan_covers_each_output_once_within_the_card_limits(dtype):
    acc = 8 if dtype == torch.float64 else 4
    for (Ny, Nx), B, sm, step in itertools.product(
            _plan_shapes(), (1, 3, 8, 128, 256, 16384), (1, 132), STEPS):
        p = vcycle.vcycle_plan(step, Ny, Nx, B, dtype, sm)
        gy, gx = ((Ny + 1) // 2, (Nx + 1) // 2) if step == "restrict" \
            else (Ny, Nx)
        where = f"{step} {(Ny, Nx, B)} {dtype} sm={sm}: {p}"
        assert p.vec == 1, where
        assert p.tiles_y * p.tile_rows >= gy > (p.tiles_y - 1) * p.tile_rows
        assert p.tiles_x * p.tile_cols >= gx > (p.tiles_x - 1) * p.tile_cols
        lanes = p.chunk
        assert lanes & (lanes - 1) == 0 and lanes * acc <= 128, where
        assert p.threads <= 256 and p.threads % lanes == 0, where
        assert p.blocks == p.tiles_y * p.tiles_x * -(-B // p.chunk), where
        h, w = p.tile_rows, p.tile_cols
        if step == "coarse":
            assert (p.tiles_y, p.tiles_x) == (1, 1), where
            smem = 0 if vcycle.vcycle_scratch(p, dtype) \
                else 2 * Ny * Nx * lanes * acc
        elif step == "restrict":
            smem = ((2 * h + 3) * (2 * w + 3) + (2 * h + 1) * (2 * w + 1)) \
                * lanes * acc
        else:
            smem = (h + 2) * (w + 2) * lanes * acc
        assert smem <= 48 * 1024, where
    # the main paths' geometries
    big = vcycle.vcycle_plan("smooth", 65, 65, 16384, torch.float32, 132)
    assert (big.tile_rows, big.chunk, big.threads) == (8, 32, 256)
    narrow = vcycle.vcycle_plan("smooth", 129, 129, 128, torch.float64, 132)
    assert (narrow.tile_rows, narrow.chunk) == (8, 16)
    coarse = vcycle.vcycle_plan("coarse", 5, 5, 128, torch.float64, 132)
    assert (coarse.chunk, coarse.blocks, coarse.threads) == (1, 128, 32)


def test_plan_is_a_pure_function_of_the_shape(monkeypatch):
    def clock(*a, **k):
        raise AssertionError("the plan read a clock")

    for name in ("time", "perf_counter", "monotonic", "process_time",
                 "perf_counter_ns", "time_ns"):
        monkeypatch.setattr(time, name, clock)
    monkeypatch.setattr(torch.cuda, "synchronize", clock)
    monkeypatch.setattr(torch.cuda, "Event", clock)
    plan = vcycle.vcycle_plan.__wrapped__
    for args in itertools.product(STEPS, (65, 129), (128, 16384),
                                  (torch.float32, torch.float64), (132,)):
        step, n, B, dt, sm = args
        assert plan(step, n, n, B, dt, sm) == plan(step, n, n, B, dt, sm)
    # a large coarsest grid keeps its z buffers in a scratch array
    big = plan("coarse", 65, 65, 8, torch.float64, 132)
    assert big.chunk == 1 and vcycle.vcycle_scratch(big, torch.float64)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, levels, rz = _levels(16, 2, "float32", seed=0)
    (c, m), (r, z) = levels[0], rz[0]
    with pytest.raises(ValueError, match="sweeps"):
        vcycle.vcycle_presmooth(c, m, r, OMEGA, 3)
    with pytest.raises(ValueError, match="sweeps"):
        vcycle.vcycle_correct(c, m, r, z, rz[1][1], OMEGA, 2)
    with pytest.raises(ValueError, match="coarse_mask"):
        vcycle.vcycle_restrict(c, m, r, z, m)
    with pytest.raises(TypeError, match="ec"):
        vcycle.vcycle_correct(c, m, r, z, rz[1][1].double(), OMEGA)
    with pytest.raises(ValueError, match="odd"):
        vcycle.vcycle_restrict(c[:, :-1], m[:-1], r[:-1], z[:-1],
                               levels[1][1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        vcycle._launch("smooth", c.to("meta"), m.to("meta"), r.to("meta"),
                       z.to("meta"))


def test_k1_library_key_follows_the_vcycle_header(tmp_path, monkeypatch):
    """The V-cycle's kernels are built into K1's library: an edit to their
    header rebuilds it and no other."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {
        name: (csrc / src.name, headers)
        for name, (src, headers) in _build.SOURCES.items()})
    assert "vcycle.cuh" in _build.SOURCES["stencil"][1]
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(csrc / "vcycle.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["stencil"] != before["stencil"]
    assert all(after[n] == before[n] for n in _build.SOURCES
               if n != "stencil")
