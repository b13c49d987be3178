"""The halo-padded stencil kernel K3 (``ops/csrc/stencil_sym_blocked.cu``)
on its launch plan, checked on the CPU.

K3 runs K2's kernel body on the padded (R, C) = (Ny+2, Nx+2) grid with the
geometry of K2's form, ``launch_plan(R, C, B, dtype, sm, True, aligned)``.
The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``); here
the plan is checked to cover every padded output once, the halo included,
and what the kernel does per work item is mirrored in PyTorch: halo nodes
store zeros, an interior node multiplies each of its seven inputs by its
node's mask and sums every term in the plain version's order, reading
neighbours without guards.  The mirror must equal
``apply_stencil_sym_blocked_reference`` bit for bit, also with +-inf, -0
and negative values on the interior nodes next to the halo and on the
halo itself.
"""

import importlib.util
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu_torch.ops import _build
from generative_physics_informed_pde_tpu_torch.ops.stencil import (
    apply_stencil_sym_blocked_reference, launch_plan)
from test_torch_stencil_plan import _bits, _items, _thread_nodes


def _chip_smoke():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Padded (R, B) of every shape K3 is measured at (``chip_smoke.K3_SHAPES``:
# the highres32 label shape and the JAX roofline benchmark's chains), each
# checked here in both dtypes.
K3_SHAPES = tuple(dict.fromkeys((R, B) for R, B, _ in
                                _chip_smoke().K3_SHAPES))
DTYPES = (torch.float32, torch.float64)
_DIRS = ((1, 0), (0, 1), (1, 1))


def _check_plan(R, C, B, dtype, sm, aligned):
    item = torch.empty((), dtype=dtype).element_size()
    p = launch_plan(R, C, B, dtype, sm, True, aligned)
    where = f"{(R, C, B)} {dtype} sm={sm} aligned={aligned}: {p}"
    assert p.vec == (16 // item if aligned and (B * item) % 16 == 0 else 1), \
        where
    lanes = p.chunk // p.vec
    assert lanes & (lanes - 1) == 0 and p.chunk * item <= 128, where
    assert p.threads <= 256 and p.threads % lanes == 0, where
    assert p.blocks == p.tiles_y * p.tiles_x * p.chunks, where
    if p.tile_rows * p.tile_cols > 1 and p.tile_rows < R:
        assert p.blocks >= 2 * sm, where
    # tiles partition the padded grid, halo included; chunks the batch
    count = np.zeros((R, C), int)
    sides = set()
    for y0, y1, x0, x1, b0, _ in _items(p, R, C, B):
        if b0 == 0:
            count[y0:y1, x0:x1] += 1
            sides.add((y1 - y0, x1 - x0))
    assert (count == 1).all(), where
    assert p.chunks * p.chunk >= B > (p.chunks - 1) * p.chunk, where
    # every thread of a block computes each of its nodes of a tile once,
    # and in a whole tile every thread has a node
    for h, w in sides:
        assert (_thread_nodes(p, h, w) == 1).all(), (where, h, w)
    assert p.threads // lanes <= p.tile_rows * p.tile_cols, where
    return p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,B", K3_SHAPES)
def test_blocked_plan_covers_every_padded_output_once(R, B, dtype):
    for sm, aligned in itertools.product((1, 16), (True, False)):
        _check_plan(R, R, B, dtype, sm, aligned)
    p = _check_plan(R, R, B, dtype, 132, True)
    # on the H100: K2's geometry (8 x 8 tiles of one 128-byte line,
    # 16-byte loads), and every chunk full, so no lane of a block idles
    item = torch.empty((), dtype=dtype).element_size()
    assert (p.tile_rows, p.chunk * item, p.vec * item) == (8, 128, 16)
    assert B % p.chunk == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,C,B", [(35, 35, 11), (6, 6, 1), (14, 9, 3),
                                   (259, 259, 65), (10, 23, 257)])
def test_blocked_plan_at_odd_batches_takes_the_scalar_path(R, C, B, dtype):
    for sm in (1, 16, 132):
        p = _check_plan(R, C, B, dtype, sm, True)
        assert p.vec == 1


def test_blocked_plan_is_k2s_form():
    """K3 takes K2's form of the plan on the padded sizes, cached per
    shape: 8 x 8 tiles of one line with 16-byte loads at (35, 35, 1024)
    f32; a grid too small for two blocks an SM gets smaller tiles."""
    k3 = launch_plan(35, 35, 1024, torch.float32, 132, True)
    assert k3 is launch_plan(35, 35, 1024, torch.float32, 132, True)
    assert (k3.tile_rows, k3.tile_cols, k3.chunk, k3.vec) == (8, 8, 32, 4)
    small = launch_plan(6, 6, 64, torch.float64, 132, True)
    assert small.tile_rows < 8 and small.vec == 2


def _mirror(plan, c, v, mask):
    """K3's algorithm in PyTorch, per work item: halo nodes store zeros;
    each interior node reads its seven neighbours unguarded, masks each v by
    its node's mask and sums c0*vm, then per direction the +dir and the
    -dir term, multiplied by its own mask at the end."""
    R, C, B = v.shape
    out = torch.full_like(v, float("nan"))
    written = torch.zeros(v.shape, dtype=torch.int64)
    for y0, y1, x0, x1, b0, b1 in _items(plan, R, C, B):
        ys, xs = torch.meshgrid(torch.arange(y0, y1), torch.arange(x0, x1),
                                indexing="ij")
        halo = (ys == 0) | (ys == R - 1) | (xs == 0) | (xs == C - 1)
        yi, xi = ys[~halo], xs[~halo]
        bs = slice(b0, b1)

        def vm(dy, dx):
            return v[yi + dy, xi + dx, bs] * mask[yi + dy, xi + dx]

        acc = c[0, yi, xi, bs] * vm(0, 0)
        for k, (oy, ox) in enumerate(_DIRS, start=1):
            acc = acc + c[k, yi, xi, bs] * vm(oy, ox)
            acc = acc + c[k, yi - oy, xi - ox, bs] * vm(-oy, -ox)
        tile = torch.zeros(y1 - y0, x1 - x0, b1 - b0, dtype=v.dtype)
        tile[~halo] = mask[yi, xi] * acc
        out[y0:y1, x0:x1, bs] = tile
        written[y0:y1, x0:x1, bs] += 1
    assert (written == 1).all()
    return out


def _blocked_inputs(R, C, B, dtype, seed, hazards=False, zero_halo=False,
                    device="cpu"):
    """K3's inputs: padded c (4, R, C, B), v (R, C, B) with +0 and -0
    entries and a 0/1 mask zero on the halo.  ``zero_halo``: c and v are
    zero on the halo, as ``pad_coefs_blocked`` and ``pad_blocked`` give
    them (else random there: the kernel assumes nothing of the halo's
    inputs).  With ``hazards`` the interior nodes next to the halo and the
    halo itself carry +-inf, -0 and negative values in c and v."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((4, R, C, B))
    v = rng.standard_normal((R, C, B))
    v[rng.random(v.shape) < 0.2] = 0.0
    v[rng.random(v.shape) < 0.1] = -0.0
    if zero_halo:
        for a in (*c, v):
            a[[0, -1]] = a[:, [0, -1]] = 0.0
    mask = np.zeros((R, C, 1))
    mask[1:-1, 1:-1] = rng.random((R - 2, C - 2, 1)) < 0.8
    if hazards:
        ring = np.zeros((R, C), bool)
        ring[[0, 1, -2, -1], :] = ring[:, [0, 1, -2, -1]] = True
        for a in (*c, v):
            pick = ring[..., None] & (rng.random((R, C, B)) < 0.3)
            a[pick] = rng.choice([np.inf, -np.inf, -0.0, -2.5],
                                 size=int(pick.sum()))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (c, v, mask))


@pytest.mark.parametrize("hazards", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocked_tiled_algorithm_equals_the_plain_version_bit_for_bit(
        dtype, hazards):
    for R, C, B in ((6, 6, 3), (11, 11, 11), (19, 19, 64), (14, 9, 1),
                    (35, 35, 20)):
        c, v, mask = _blocked_inputs(R, C, B, dtype, R * 100 + B, hazards)
        ref = apply_stencil_sym_blocked_reference(c, v, mask)
        for sm in (1, 132):
            p = launch_plan(R, C, B, dtype, sm, True)
            got = _mirror(p, c, v, mask)
            assert torch.equal(_bits(got), _bits(ref)), (R, C, B, p)
        # the output halo is +0 exactly, whatever the halo's inputs
        for edge in (ref[0], ref[-1], ref[:, 0], ref[:, -1]):
            assert torch.equal(_bits(edge), torch.zeros_like(_bits(edge)))
        if hazards:
            assert bool(torch.isnan(ref).any()) and bool(
                torch.isinf(ref).any())


def test_blocked_build_key_names_the_headers_it_includes(tmp_path,
                                                         monkeypatch):
    """K3's library includes K2's kernel body (``stencil_sym.cuh``) and the
    shared tile header; ``_build.SOURCES`` names both, and an edit to either
    rebuilds K3."""
    source, headers = _build.SOURCES["stencil_sym_blocked"]
    included = re.findall(r'^#include "([^"]+)"', source.read_text(), re.M)
    assert sorted(headers) == sorted(included) == ["stencil_sym.cuh",
                                                   "stencil_tile.cuh"]
    assert _build.SOURCES["stencil_sym"][1] == headers

    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {
        name: (csrc / src.name, hs)
        for name, (src, hs) in _build.SOURCES.items()})
    seen = {_build.library_path("stencil_sym_blocked")}
    for h in headers:
        with open(csrc / h, "a") as f:
            f.write("// edited\n")
        seen.add(_build.library_path("stencil_sym_blocked"))
    assert len(seen) == 3


def test_k2_and_k3_instantiate_one_kernel_body():
    """The kernel body lives in ``stencil_sym.cuh`` alone; K2 launches it
    unpadded and K3 padded."""
    csrc = _build.CSRC
    body = "apply_stencil_sym_kernel"
    assert body in (csrc / "stencil_sym.cuh").read_text()
    for name, padded in (("stencil_sym.cu", "false"),
                         ("stencil_sym_blocked.cu", "true")):
        text = (csrc / name).read_text()
        assert "__global__" not in text and body not in text, name
        launches = set(re.findall(r"launch_sym<\w+, (\w+)>", text))
        assert launches == {padded}, name
