"""The port's shardings place the same rows as the JAX package's.

On conftest's 8 virtual CPU devices the JAX package's ``batch_sharding``
and ``mc_batch_sharding`` say which rows each device holds
(``devices_indices_map``); the port's process at the same mesh
coordinate must hold the same rows.  Checked for a dp mesh of 8, a
("dp", "mc") mesh of (4, 2) and a hybrid ("dcn", "dp") mesh of (2, 4).
The port's ``Sharding`` reads only the mesh's axis names and shape to
place rows, so its meshes here are stand-ins seen from one coordinate
(no process group).  ``shard_train_state`` splits the same leaves in both
packages: the per-datapoint blocks, their Adam moments and the prediction
ensemble's posterior and moments, each to the rows the JAX package puts
on that device; every other leaf stays whole.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from generative_physics_informed_pde_tpu import parallel as jpar
from generative_physics_informed_pde_tpu_torch import parallel
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)

MESHES = {"dp8": (("dp",), (8,)), "dp_mc": (("dp", "mc"), (4, 2)),
          "hybrid": (("dcn", "dp"), (2, 4))}


class _At:
    """A mesh's axes and shape, seen from the process at ``coordinate``."""

    def __init__(self, names, shape, coordinate=None):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self.coordinate = coordinate

    def get_coordinate(self):
        return self.coordinate


def _jax_mesh(key):
    names, shape = MESHES[key]
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), names)


def _jax_rows(sharding, n, mesh):
    """{mesh coordinate: (start, stop)} of each device's rows."""
    out = {}
    for dev, idx in sharding.devices_indices_map((n, 3)).items():
        coord = tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0])
        sl = idx[0]
        out[coord] = (sl.start or 0, n if sl.stop is None else sl.stop)
    return out


def _port_rows(sharding, n, coords):
    out = {}
    for c in coords:
        sl = sharding.rows(n, c)
        out[c] = (sl.start, sl.stop)
    return out


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("which", ["batch", "mc_batch"])
def test_each_coordinate_holds_the_jax_rows(key, which):
    jmesh = _jax_mesh(key)
    names, shape = MESHES[key]
    pmesh = _At(names, shape)
    if which == "batch":
        jsh, psh = jpar.batch_sharding(jmesh), parallel.batch_sharding(pmesh)
    else:
        jsh = jpar.mc_batch_sharding(jmesh)
        psh = parallel.mc_batch_sharding(pmesh)
    for n in (16, 64):
        want = _jax_rows(jsh, n, jmesh)
        assert _port_rows(psh, n, want) == want, (key, which, n)


def test_batch_pspec_matches_jax():
    for key in MESHES:
        jmesh, (names, shape) = _jax_mesh(key), MESHES[key]
        want = jpar.mesh.batch_pspec(jmesh, "dp")[0]
        want = want if isinstance(want, tuple) else (want,)
        assert parallel.batch_pspec(_At(names, shape), "dp") == want
    assert parallel.batch_pspec(_At(("dcn", "dp"), (2, 4))) == ("dcn", "dp")
    for names, axis in ((("dp",), "pd"), (("dcn", "dp"), "mc")):
        with pytest.raises(ValueError, match="not in mesh axes"):
            parallel.batch_pspec(_At(names, (8,) * len(names)), axis)
        with pytest.raises(ValueError, match="not in mesh axes"):
            jpar.mesh.batch_pspec(
                Mesh(np.array(jax.devices()[:8]).reshape(
                    (8,) if len(names) == 1 else (2, 4)), names), axis)


def test_mc_batch_sharding_joint_split():
    """The JAX package's ``test_mc_batch_sharding_joint_split``: 16 rows
    over (4 dp x 2 mc) -> each process holds 2 contiguous rows, dp-major
    (each dp block keeps its data samples, 'mc' splits their replicates)."""
    coords = [(d, m) for d in range(4) for m in range(2)]
    psh = parallel.mc_batch_sharding(_At(("dp", "mc"), (4, 2)))
    assert psh.num_shards == 8
    rows = [psh.rows(16, c) for c in coords]
    assert [r.stop - r.start for r in rows] == [2] * 8
    assert [r.start for r in rows] == list(range(0, 16, 2))
    flat = torch.arange(16 * 4.0).reshape(16, 4)
    parts = [parallel.mc_batch_sharding(
        _At(("dp", "mc"), (4, 2), c)).shard(flat) for c in coords]
    assert torch.equal(torch.cat(parts), flat)
    # each dp block's 4 rows are its data samples' replicates
    dp_rows = [parallel.batch_sharding(_At(("dp", "mc"), (4, 2), (d, 0)))
               .rows(16) for d in range(4)]
    assert [(r.start, r.stop) for r in dp_rows] == [(0, 4), (4, 8),
                                                     (8, 12), (12, 16)]


def test_global_array_from_local_and_hybrid_mesh_checks():
    mesh = parallel.make_mesh(1, device="cpu")
    x = np.arange(12.0).reshape(6, 2)
    got = parallel.global_array_from_local(mesh, x)
    assert isinstance(got, torch.Tensor) and torch.equal(
        got, torch.as_tensor(x))
    parallel.global_array_from_local(mesh, x, global_shape=(6, 2))
    with pytest.raises(ValueError, match="global"):
        parallel.global_array_from_local(mesh, x, global_shape=(12, 2))
    with pytest.raises(ValueError, match="multi-leaf"):
        parallel.global_array_from_local(mesh, {"a": x, "b": x},
                                         global_shape=(6, 2))
    with pytest.raises(ValueError, match="multi-leaf"):
        jpar.global_array_from_local(jpar.make_mesh(1), {"a": x, "b": x},
                                     global_shape=(6, 2))
    hmesh = parallel.make_hybrid_mesh(("dp",), device="cpu")
    assert hmesh.mesh_dim_names == ("dcn", "dp") and hmesh.shape == (1, 1)
    with pytest.raises(ValueError, match="local_shape"):
        parallel.make_hybrid_mesh(("dp",), (2,), device="cpu")
    with pytest.raises(ValueError, match="local_shape"):
        jpar.make_hybrid_mesh(("dp",), (3,))


# ------------------------------------------------------ shard_train_state
N_S, N_VAL = 16, 8


def _jax_state():
    """A JAX TrainState of the highres32 model: 16 labeled fields, the
    amortized unlabeled term, 8 validation fields."""
    import optax
    from generative_physics_informed_pde_tpu.factories.model import (
        ModelFactory)
    from generative_physics_informed_pde_tpu.inference import variational
    from generative_physics_informed_pde_tpu.training.trainer import (
        TrainState)

    _, model, _, _, dt = ModelFactory.FromIdentifier("highres32").setup()
    X = jnp.zeros((N_S, 32, 32), dt)
    params, bs = model.init_params(jax.random.PRNGKey(0),
                                   {"supervised": {"X": X},
                                    "unsupervised": {"X": X}}, (32, 32))
    pe_q = variational.init_variational(N_VAL, model.dim_latent, dtype=dt)
    opt = optax.adam(1e-3)
    return TrainState(params=params, opt_state=opt.init(params),
                      batch_stats=bs, pe_q=pe_q,
                      pe_opt_state=opt.init(pe_q),
                      key=jax.random.PRNGKey(0),
                      step=jnp.zeros((), jnp.int32))


def _jax_split_leaves(state, mesh):
    """{canonical name: {((coordinate, rows), ...)}} of the leaves the JAX
    package splits, and the number of leaves it keeps whole."""
    placed = jpar.shard_train_state(state, mesh)
    split, whole = {}, 0
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    for path, leaf in flat:
        if leaf.sharding.is_fully_replicated:
            whole += 1
            continue
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        keys = [str(k) for k in keys if k is not None]
        if keys[0] == "params":
            name = "/".join(keys[1:])
        elif keys[0] == "opt_state":  # optax adam: mu / nu mirror params
            name = "opt:" + "/".join(keys[-3:])
        elif keys[0] == "pe_q":
            name = "pe_q/" + keys[-1]
        else:  # pe_opt_state
            name = "pe_opt:" + keys[-1]
        idx = leaf.sharding.devices_indices_map(leaf.shape)
        coord0 = {}
        for dev, ix in idx.items():
            c = tuple(int(v) for v in np.argwhere(mesh.devices == dev)[0])
            coord0[c] = (ix[0].start or 0, ix[0].stop or leaf.shape[0])
        split.setdefault(name, set()).add(tuple(sorted(coord0.items())))
    return split, whole


def _port_trainer():
    X = np.random.default_rng(0).normal(size=(N_S + N_VAL + 16, 32, 32))
    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs["dtype"] = "float64"
    p.trainer.update(lr_init=1e-2, N_PE_interval=1, N_PE_updates=1)
    p.data.update(N_u=16, N_s=N_S, N_u_max=16, N_s_max=N_S, N_val=N_VAL,
                  armortized_bs=8)
    dl = DataLoader(X[:N_S + N_VAL])
    dl.assemble(__import__(
        "generative_physics_informed_pde_tpu_torch").fem.make_fom_rom_pair(
            "NDP", 4, 4, 3, device="cpu"), label_batch=8)
    dlu = DataLoader(X[N_S + N_VAL:])
    dlu.lock_physics_assembly()
    tr = CreateTrainer(p, dl, dlu, device="cpu")
    tr.step()  # Adam's moments exist after a step
    return tr


def _port_tensors(tr):
    """{port name: tensor} of every parameter and Adam moment of the
    model and the prediction ensemble, live."""
    out = {}
    for n, p in tr.model.named_parameters():
        out[n] = p
        for m in ("exp_avg", "exp_avg_sq"):
            out[f"opt:{n}:{m}"] = tr.optimizer.state[p][m]
    for k, v in tr._PE.q.items():
        out["pe_q/" + k] = v
        for m in ("exp_avg", "exp_avg_sq"):
            out[f"pe_opt:{k}:{m}"] = tr._PE.optimizer.state[v][m]
    return out


def _port_split_leaves(names, shape, coords):
    """The port's ``shard_train_state`` on a set-up trainer, seen from each
    coordinate (every tensor first filled with distinct values):
    {port name: {coordinate: rows}} of the tensors it cuts; every other
    tensor keeps its values."""
    split = {}
    for c in coords:
        tr = _port_trainer()
        with torch.no_grad():
            for t in _port_tensors(tr).values():
                t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(
                    t.shape))
        before = {k: t.detach().clone()
                  for k, t in _port_tensors(tr).items()}
        parallel.shard_train_state(tr, _At(names, shape, c))
        for k, t in _port_tensors(tr).items():
            ref = before[k]
            if t.shape == ref.shape:
                assert torch.equal(t.detach(), ref), k
                continue
            width = ref[0].numel()
            lo = int(t.reshape(-1)[0]) // width
            assert torch.equal(t.detach(), ref[lo:lo + t.shape[0]]), k
            split.setdefault(k, {})[c] = (lo, lo + t.shape[0])
    return split


def _canonical_port(name):
    """q_z.supervised.mean -> q_z/supervised/mean; opt:...:exp_avg ->
    opt:q_z/supervised/mean; pe_opt:mean:exp_avg -> pe_opt:mean."""
    if name.startswith("opt:"):
        return "opt:" + name.split(":")[1].replace(".", "/")
    if name.startswith("pe_opt:"):
        return "pe_opt:" + name.split(":")[1]
    return name.replace(".", "/")


@pytest.mark.parametrize("key", ["dp8", "dp_mc"])
def test_shard_train_state_splits_the_same_leaves(key):
    names, shape = MESHES[key]
    jmesh = _jax_mesh(key)
    jsplit, jwhole = _jax_split_leaves(_jax_state(), jmesh)
    # two coordinates of the port: the first and the last
    coords = [(0,) * len(shape), tuple(s - 1 for s in shape)]
    canon = {}
    for k, v in _port_split_leaves(names, shape, coords).items():
        canon.setdefault(_canonical_port(k), []).append(v)
    assert sorted(canon) == sorted(jsplit), (sorted(canon), sorted(jsplit))
    for name, placements in jsplit.items():
        (jrows,) = placements
        jrows = dict(jrows)
        for rows in canon[name]:
            for c in coords:
                assert rows[c] == jrows[c], (name, c)
    assert jwhole > 0  # the JAX package keeps the other leaves whole too
