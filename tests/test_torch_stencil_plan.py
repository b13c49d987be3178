"""The launch plan of the tiled stencil kernels K1 and K2
(``ops/stencil.py`` ``launch_plan``), checked on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``); what
they do with the plan's geometry is mirrored here in PyTorch: the work
items, the threads' share of each item, and per item the tile's values
with zeros outside the grid (where the kernels load zeros instead of
reading) summed in the plain version's order.  The mirror must equal the
plain versions bit for bit, also where coefficients next to the grid edge
hold +-inf and negative values (a zero neighbour then gives -0 * ... and
inf * 0 = NaN, exactly as the plain version's zero padding does).
"""

import itertools

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu_torch.ops import stencil
from generative_physics_informed_pde_tpu_torch.ops.stencil import (
    apply_stencil_reference, apply_stencil_sym_reference, launch_plan)

LEVELS = (65, 33, 17, 9, 5)             # V-cycle node counts at 64^2
BATCHES = (1, 3, 11, 200, 256, 257, 1024, 2048)
SM_COUNTS = (1, 16, 132)
DTYPES = (torch.float32, torch.float64)


def _items(plan, Ny, Nx, B):
    """(y0, y1, x0, x1, b0, b1) of every work item, in item order."""
    for ty, tx, c in itertools.product(range(plan.tiles_y),
                                       range(plan.tiles_x),
                                       range(plan.chunks)):
        yield (ty * plan.tile_rows, min((ty + 1) * plan.tile_rows, Ny),
               tx * plan.tile_cols, min((tx + 1) * plan.tile_cols, Nx),
               c * plan.chunk, min((c + 1) * plan.chunk, B))


def _thread_nodes(plan, h, w):
    """Per node of an h x w tile, how many threads sum it, for each lane:
    the kernels' walk (``NodeWalk``) from node ``slot`` in steps of
    ``slots`` nodes, row-major."""
    lanes = plan.chunk // plan.vec
    slots = plan.threads // lanes
    hits = np.zeros((h, w, lanes), int)
    for t in range(plan.threads):
        lane, slot = t % lanes, t // lanes
        ly, lx = divmod(slot, w)
        dy, dx = divmod(slots, w)
        while ly < h:
            hits[ly, lx, lane] += 1
            ly, lx = ly + dy, lx + dx
            if lx >= w:
                ly, lx = ly + 1, lx - w
    return hits


def _shapes():
    yield from ((n, n) for n in LEVELS)
    yield from ((7, 12), (12, 7), (1, 1), (2, 40))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_every_output_once(dtype, sym):
    item = torch.empty((), dtype=dtype).element_size()
    for (Ny, Nx), B, sm in itertools.product(_shapes(), BATCHES, SM_COUNTS):
        for aligned in (True, False):
            p = launch_plan(Ny, Nx, B, dtype, sm, sym, aligned)
            where = f"{(Ny, Nx, B)} {dtype} sm={sm} aligned={aligned}: {p}"
            # the 16-byte path only where every access is 16-byte aligned:
            # K2 there, K1 never (it measured slower)
            assert p.vec in (1, 16 // item), where
            assert (p.vec > 1) == (sym and aligned and (B * item) % 16 == 0
                                   ), where
            assert p.chunk * item <= (128 if sym else 512), where
            assert p.chunk % p.vec == 0 and B % p.vec == 0, where
            lanes = p.chunk // p.vec
            assert lanes & (lanes - 1) == 0, where  # a power of two
            assert p.threads <= 256 and p.threads % lanes == 0, where
            # one block per (tile, chunk), as many as the C side requires;
            # tiles shrink (to one node) while there are fewer blocks than
            # two an SM
            assert p.blocks == p.tiles_y * p.tiles_x * p.chunks, where
            if p.tile_rows * p.tile_cols > 1 and p.tile_rows < Ny:
                assert p.blocks >= 2 * sm, where
            # tiles and chunks partition the grid and the batch
            count = np.zeros((Ny, Nx), int)
            for y0, y1, x0, x1, b0, b1 in _items(p, Ny, Nx, B):
                if b0 == 0:
                    assert 0 < y1 - y0 <= p.tile_rows, where
                    assert 0 < x1 - x0 <= p.tile_cols, where
                    count[y0:y1, x0:x1] += 1
            assert (count == 1).all(), where
            assert p.chunks * p.chunk >= B > (p.chunks - 1) * p.chunk, where


@pytest.mark.parametrize("sym", [False, True])
def test_threads_sum_every_node_of_an_item_once(sym):
    for (Ny, Nx), B, dtype in itertools.product(_shapes(), BATCHES, DTYPES):
        p = launch_plan(Ny, Nx, B, dtype, 132, sym)
        for y0, y1, x0, x1, _, _ in itertools.islice(_items(p, Ny, Nx, B),
                                                     0, None, p.chunks):
            hits = _thread_nodes(p, y1 - y0, x1 - x0)
            assert (hits == 1).all(), (Ny, Nx, B, dtype, p)


def test_plan_is_chosen_by_shape_and_the_16_byte_path_by_alignment():
    k1 = launch_plan(33, 33, 1024, torch.float32, 132)
    assert k1 is launch_plan(33, 33, 1024, torch.float32, 132)  # cached
    # K1: 2 x 2 tiles of 512-byte chunks, scalar loads
    assert (k1.tile_rows, k1.tile_cols, k1.chunk, k1.vec) == (2, 2, 128, 1)
    assert launch_plan(33, 33, 256, torch.float64, 132).chunk == 64
    # K2: 8 x 8 tiles of one line, 16-byte loads where alignment allows
    k2 = launch_plan(33, 33, 1024, torch.float32, 132, sym=True)
    assert (k2.tile_rows, k2.tile_cols, k2.chunk, k2.vec) == (8, 8, 32, 4)
    assert launch_plan(33, 33, 1024, torch.float64, 132, True).vec == 2
    assert launch_plan(33, 33, 257, torch.float32, 132, True).vec == 1
    assert launch_plan(33, 33, 1024, torch.float32, 132, True,
                       aligned=False).vec == 1
    # the coarse V-cycle levels: tiles shrink until the grid fills the SMs
    coarse = launch_plan(9, 9, 256, torch.float64, 132)
    assert coarse.tile_rows == 1 and coarse.blocks == 324


def _mirror(plan, coefs, v, mask, sym):
    """The kernels' algorithm in PyTorch: per work item, the tile of v
    (and for K2 c_N, c_E, c_D) with a one-node halo, zero outside the grid
    (the kernels' guarded loads), each output summed from it in the plain
    version's order."""
    Ny, Nx, B = v.shape
    out = torch.zeros_like(v)
    written = torch.zeros(v.shape, dtype=torch.int64)

    def tile(grid, y0, x0, rh, rw, b0, b1):
        t = torch.zeros(rh, rw, plan.chunk, dtype=v.dtype)
        ys = [y for y in range(y0, y0 + rh) if 0 <= y < Ny]
        xs = [x for x in range(x0, x0 + rw) if 0 <= x < Nx]
        if ys and xs:  # the guarded reads: nodes in the grid, b < B
            t[ys[0] - y0:ys[-1] - y0 + 1, xs[0] - x0:xs[-1] - x0 + 1,
              :b1 - b0] = grid[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1, b0:b1]
        return t

    for y0, y1, x0, x1, b0, b1 in _items(plan, Ny, Nx, B):
        h, w = y1 - y0, x1 - x0
        sv = tile(v, y0 - 1, x0 - 1, h + 2, w + 2, b0, b1)

        def vt(oy, ox):
            return sv[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

        if sym:
            c0 = torch.zeros(h, w, plan.chunk, dtype=v.dtype)
            c0[..., :b1 - b0] = coefs[0, y0:y1, x0:x1, b0:b1]
            acc = c0 * vt(0, 0)
            for d, (oy, ox) in enumerate(((1, 0), (0, 1), (1, 1))):
                sd = tile(coefs[1 + d], y0 - 1, x0 - 1, h + 1, w + 1, b0, b1)
                acc = acc + sd[1:, 1:] * vt(oy, ox)
                acc = acc + sd[1 - oy:1 - oy + h, 1 - ox:1 - ox + w] \
                    * vt(-oy, -ox)
        else:
            acc = torch.zeros(h, w, plan.chunk, dtype=v.dtype)
            for k, (oy, ox) in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1),
                                          (0, -1), (1, 1), (-1, -1))):
                ck = torch.zeros(h, w, plan.chunk, dtype=v.dtype)
                ck[..., :b1 - b0] = coefs[k, y0:y1, x0:x1, b0:b1]
                acc = acc + ck * vt(oy, ox)
        out[y0:y1, x0:x1, b0:b1] = (mask[y0:y1, x0:x1] * acc)[..., :b1 - b0]
        written[y0:y1, x0:x1, b0:b1] += 1
    assert (written == 1).all()
    return out


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _inputs(Ny, Nx, B, dtype, n_grids, seed, hazards):
    rng = np.random.default_rng(seed)
    coefs = rng.standard_normal((n_grids, Ny, Nx, B))
    v = rng.standard_normal((Ny, Nx, B))
    v[rng.random(v.shape) < 0.2] = 0.0          # exact zeros, some of them
    v[rng.random(v.shape) < 0.1] = -0.0         # negative
    mask = (rng.random((Ny, Nx, 1)) < 0.8).astype(float)
    if hazards:  # +-inf, -0 and negative values on the grid's edge nodes
        edge = np.zeros((Ny, Nx), bool)
        edge[[0, -1], :] = edge[:, [0, -1]] = True
        for k in range(n_grids):
            pick = edge[..., None] & (rng.random((Ny, Nx, B)) < 0.3)
            coefs[k][pick] = rng.choice([np.inf, -np.inf, -0.0, -2.5],
                                        size=int(pick.sum()))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (coefs, v, mask))


@pytest.mark.parametrize("hazards", [False, True])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_algorithm_equals_the_plain_version_bit_for_bit(dtype, sym,
                                                              hazards):
    plain = apply_stencil_sym_reference if sym else apply_stencil_reference
    for (Ny, Nx), B in (((5, 5), 3), ((9, 9), 11), ((17, 17), 200),
                        ((12, 7), 1), ((33, 33), 20)):
        coefs, v, mask = _inputs(Ny, Nx, B, dtype, 4 if sym else 7,
                                 Ny * 100 + B, hazards)
        for sm in (1, 132):
            p = launch_plan(Ny, Nx, B, dtype, sm, sym)
            got = _mirror(p, coefs, v, mask, sym)
            ref = plain(coefs, v, mask)
            assert torch.equal(_bits(got), _bits(ref)), (Ny, Nx, B, p)
        if hazards:
            assert bool(torch.isnan(ref).any()) and bool(
                torch.isinf(ref).any())


def test_skipping_the_out_of_grid_terms_would_not_be_bit_equal():
    """Why the kernels add the out-of-grid terms as c * 0 from a zero halo
    rather than skip them: the plain version pads v with zeros, so an inf
    coefficient on an edge node pointing out of the grid gives NaN, and a
    -0 sum becomes +0."""
    coefs, v, mask = _inputs(5, 5, 8, torch.float64, 7, 1, True)
    mask = torch.ones_like(mask)
    ref = apply_stencil_reference(coefs, v, mask)
    skipped = torch.zeros_like(v)
    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
    for y, x in itertools.product(range(5), range(5)):
        acc = coefs[0, y, x] * v[y, x]
        for k, (oy, ox) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1),
                                      (1, 1), (-1, -1)), start=1):
            if 0 <= y + oy < 5 and 0 <= x + ox < 5:
                acc = acc + coefs[k, y, x] * vp[1 + y + oy, 1 + x + ox]
        skipped[y, x] = acc
    assert not torch.equal(_bits(skipped), _bits(ref))
    assert torch.equal(_bits(_mirror(launch_plan(5, 5, 8, torch.float64, 1),
                                     coefs, v, mask, False)), _bits(ref))


def test_wrapper_resolves_each_kernel_once(monkeypatch):
    """``_kernel`` looks a symbol up in its library once per process; every
    entry point takes the plan (K3's too)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            calls.append(name)
            return type("Fn", (), {"argtypes": None, "restype": None})()

    from generative_physics_informed_pde_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    monkeypatch.setattr(stencil, "_FNS", {})
    first = stencil._kernel("stencil", "gpipde_apply_stencil_f32")
    again = stencil._kernel("stencil", "gpipde_apply_stencil_f32")
    assert first is again and calls == ["gpipde_apply_stencil_f32"]
    assert len(first.argtypes) == 10
    k3 = stencil._kernel("stencil_sym_blocked",
                         "gpipde_apply_stencil_sym_blocked_f64")
    assert len(k3.argtypes) == 10


def test_each_library_lists_the_headers_it_includes():
    """``_build.SOURCES`` names, per library, the ``csrc/`` headers its
    source includes, and no others."""
    import re

    from generative_physics_informed_pde_tpu_torch.ops import _build

    for name, (source, headers) in _build.SOURCES.items():
        included = re.findall(r'^#include "([^"]+)"', source.read_text(),
                              re.M)
        assert sorted(headers) == sorted(included), name
        assert all((_build.CSRC / h).is_file() for h in headers), name


def test_library_key_follows_its_own_source_and_headers(tmp_path,
                                                         monkeypatch):
    """An edit to the shared header rebuilds all three libraries, an edit
    to the symmetric body's header K2 and K3 and not K1; an edit to a
    source rebuilds that library alone."""
    import shutil

    from generative_physics_informed_pde_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {
        name: (csrc / src.name, headers)
        for name, (src, headers) in _build.SOURCES.items()})

    def keys():
        return {name: _build.library_path(name) for name in _build.SOURCES}

    before = keys()
    with open(csrc / "stencil_tile.cuh", "a") as f:
        f.write("// edited\n")
    after = keys()
    assert all(after[n] != before[n] for n in _build.SOURCES)
    with open(csrc / "stencil_sym.cuh", "a") as f:
        f.write("// edited\n")
    sym = keys()
    assert sym["stencil"] == after["stencil"]
    assert sym["stencil_sym"] != after["stencil_sym"]
    assert sym["stencil_sym_blocked"] != after["stencil_sym_blocked"]
    with open(csrc / "stencil_sym_blocked.cu", "a") as f:
        f.write("// edited\n")
    again = keys()
    assert again["stencil_sym_blocked"] != sym["stencil_sym_blocked"]
    assert again["stencil"] == sym["stencil"]
    assert again["stencil_sym"] == sym["stencil_sym"]
