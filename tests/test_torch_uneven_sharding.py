"""Sharded training with batches that do not divide by the shard count.

On a mesh whose batch axes have ``k`` shards, the JAX package refuses
(``ValueError`` from ``jax.device_put``) the sizes of per-datapoint
blocks that ``k`` does not divide, and trains the batches without
per-datapoint state, whose uneven layout GSPMD makes.  The seven cases
of a 4-shard ``dp`` axis (``tests/test_parallel.py``'s ``_make_trainer``
recipe, one size changed):

==========================  ===========================  ==========
case                        change                       JAX package
==========================  ===========================  ==========
``N_s``                     ``N_s`` = 6                  refuses
``N_val``                   ``N_val`` = 6                refuses
``N_vo``                    ``N_vo`` = 6 (energy VO)     refuses
``N_u_non_amortized``       ``N_u`` = 14, no encoder     refuses
``N_u_amortized``           ``N_u`` = 14                 trains
``armortized_bs``           ``armortized_bs`` = 6        trains
``mc_rows``                 ``N_s`` = 12, 3 samples on   trains
                            a (4, 2) ("dp", "mc") mesh
==========================  ===========================  ==========

Here both packages meet each case: the JAX package on conftest's 8
virtual devices, the port on a stand-in mesh seen from its first
coordinate (the refusal comes before any collective).  Two gloo
processes of the port (this file run as a script with ``--child``) then
train the three uneven cases at two shards and are held to one process
in f64 to 1e-9 of the scale: ``N_u`` = 15 amortized (the unlabeled set
kept whole), ``armortized_bs`` = 7 (with dropout, fused decodes and
``normalize``), ``armortized_bs`` = 1 (a process with no row of the
minibatch) and ``N_s`` = 5 with 3 samples on a (1, 2) ("dp", "mc")
mesh (15 Monte-Carlo rows over 2).  The ``armortized_bs`` run's
checkpoint resumes in one process and equals the unbroken run.  The
children start with the module, so they run beside the JAX package's
cases.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))
from generative_physics_informed_pde_tpu_torch import parallel  # noqa: E402
from generative_physics_informed_pde_tpu_torch.parallel.layout import (  # noqa
    TrainLayout, share)
from test_torch_sharded_training import (  # noqa: E402
    CHILD_TIMEOUT, SIGNALS, _assert_close, _draw_pools, _make_trainer,
    _record)

# case -> (the port recipe's change, whether the JAX package trains it)
CASES = {
    "N_s": (dict(data=dict(N_s=6)), False),
    "N_val": (dict(data=dict(N_val=6)), False),
    "N_vo": (dict(energy=True, data=dict(N_vo=6)), False),
    "N_u_non_amortized": (dict(data=dict(N_u=14), amortized=False), False),
    "N_u_amortized": (dict(data=dict(N_u=14)), True),
    "armortized_bs": (dict(data=dict(armortized_bs=6)), True),
    "mc_rows": (dict(data=dict(N_s=12), n_mc=3), True),
}
STEPS, RESUMED_STEPS, CKPT_RUN = 3, 2, "armortized_bs"


def runs(world=2):
    """The uneven runs of ``world`` processes: name -> (mesh: "dp" all
    processes on 'dp', "mc" a (world / 2, 2) ("dp", "mc") mesh;
    ``_make_trainer``'s recipe), STEPS steps each.  Two processes: 15
    unlabeled fields (kept whole), a minibatch of 7 (4 / 3), a minibatch
    of 1 (the second process holds none of it) and 5 labeled fields x 3
    samples (15 Monte-Carlo rows, 8 / 7)."""
    return {
        "N_u_amortized": ("dp", dict(seed=11, data=dict(N_u=15))),
        "empty_share": ("dp", dict(seed=11, data=dict(armortized_bs=1))),
        "armortized_bs": ("dp", dict(seed=11, data=dict(armortized_bs=7),
                                     margs={"droprate": 0.2,
                                            "fuse_decodes": True},
                                     trainer={"normalize": True})),
        "mc_rows": ("mc", dict(seed=13, n_mc=3,
                               data=dict(N_s=5 * (world // 2)),
                               margs={"droprate": 0.2})),
    }


RUNS = runs()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_shape(case):
    return (4, 2) if case == "mc_rows" else (4,)


# ------------------------------------------------------ the two processes
def _child(rank: int, world: int, init: str, out: str,
           device: str = "cpu") -> None:
    """The uneven runs on two processes and the checkpoint of
    ``CKPT_RUN``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert parallel.initialize(f"file://{init}", world, rank, device=device)
    with np.load(os.path.join(out, "pools.npz")) as f:
        pools = (f["X"], f["Xu"])
    meshes = {"dp": parallel.make_mesh(device=device),
              "mc": parallel.make_mesh(world, ("dp", "mc"),
                                       (world // 2, 2), device=device)}
    rec = {}
    for name, (mesh_name, recipe) in runs(world).items():
        mesh = meshes[mesh_name]
        tr = _make_trainer(pools, mesh=mesh, device=device, **recipe)
        assert (tr.model.mc_sharding is not None) == (mesh_name == "mc")
        for _ in range(STEPS):
            tr.step()
        if name == CKPT_RUN:
            tr.save_checkpoint(os.path.join(out, "uneven_ckpt.pt"))
        rec.update({f"{name}/{k}": v for k, v in _record(tr, mesh).items()})
    rec["backend"] = np.asarray(dist.get_backend())
    np.savez(os.path.join(out, f"uneven.rank{rank}.npz"), **rec)
    dist.destroy_process_group()


class _Children:
    """The two child processes, started at once; ``records()`` waits for
    them (killed after CHILD_TIMEOUT s) and loads each one's record."""

    def __init__(self, pools_path, out: Path, device="cpu", world=2):
        import shutil

        shutil.copy(pools_path, out / "pools.npz")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
            "PYTHONPATH", "")
        for k in SIGNALS:
            env.pop(k, None)
        self.out, self.world, self._recs = out, world, None
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", str(r), str(world),
             str(out / "init"), str(out), device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def records(self):
        if self._recs is None:
            outs = []
            for pr in self.procs:
                try:
                    o, _ = pr.communicate(timeout=CHILD_TIMEOUT)
                except subprocess.TimeoutExpired:
                    self.kill()
                    o, _ = pr.communicate()
                outs.append(o)
            for r, pr in enumerate(self.procs):
                assert pr.returncode == 0, \
                    f"rank {r} failed:\n{outs[r][-4000:]}"
            self._recs = [dict(np.load(self.out / f"uneven.rank{r}.npz"))
                          for r in range(self.world)]
        return self._recs

    def kill(self):
        for pr in self.procs:
            if pr.poll() is None:
                pr.kill()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    X, Xu = _draw_pools()
    path = tmp_path_factory.mktemp("uneven_pools") / "pools.npz"
    np.savez(path, X=X, Xu=Xu)
    return X, Xu, path


@pytest.fixture(scope="module", autouse=True)
def children(pools, tmp_path_factory):
    """Started with the module's first test, so that they train while the
    JAX package's cases compile."""
    ch = _Children(pools[2], tmp_path_factory.mktemp("uneven_children"))
    yield ch
    ch.kill()


def one_process_runs(pools, world=2, device="cpu"):
    """Each run of ``runs(world)`` unsharded in this process on
    ``device``: {name: (trainer, record)}."""
    out = {}
    for name, (_, recipe) in runs(world).items():
        tr = _make_trainer(pools, device=device, **recipe)
        for _ in range(STEPS):
            tr.step()
        out[name] = (tr, _record(tr))
    return out


@pytest.fixture(scope="module")
def one_process(pools):
    return one_process_runs(pools)


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("n,k", [(6, 4), (7, 2), (15, 2), (2, 4), (16, 4)])
def test_uneven_rows_tile_the_batch_as_gspmd(n, k):
    """``ceil(n / k)`` rows a shard, in order, the last short or empty."""
    parts = [share(n, k, i) for i in range(k)]
    c = math.ceil(n / k)
    assert parts[0][0] == 0 and parts[-1][1] == n
    for (lo, hi), (lo2, _) in zip(parts, parts[1:]):
        assert hi == lo2
    assert [hi - lo for lo, hi in parts] == [
        max(0, min(c, n - i * c)) for i in range(k)]


class _StandIn:
    """A mesh of the port seen from one coordinate, with no process
    group: enough for ``TrainLayout`` and for ``setup``'s checks."""

    def __init__(self, names, shape, coordinate=None):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self.coordinate = coordinate or (0,) * len(self.shape)
        self.device = torch.device("cpu")
        self.device_type = "cpu"

    def size(self):
        return math.prod(self.shape)

    def get_coordinate(self):
        return self.coordinate

    def group(self, axes):
        return None


@pytest.mark.parametrize("n,n_mc", [(12, 3), (8, 4), (4, 3)])
def test_monte_carlo_rows_tile_each_block(n, n_mc):
    """On a (4, 2) ("dp", "mc") mesh every process decodes Monte-Carlo
    rows of its own data block only, and the processes' rows tile the
    whole batch."""
    names, shape = ("dp", "mc"), (4, 2)
    seen = []
    for coord in np.ndindex(*shape):
        L = TrainLayout(_StandIn(names, shape, coord))
        (a, b), = L.joint(n, n_mc).segments
        lo, hi = L.rows(n).segments[0]
        assert lo * n_mc <= a <= b <= hi * n_mc
        sub = L.replica_block(torch.arange((hi - lo) * n_mc))
        assert sub.tolist() == list(range(a - lo * n_mc, b - lo * n_mc))
        seen += range(a, b)
    assert sorted(seen) == list(range(n * n_mc))


# ----------------------------------------------- both packages, 4 shards
@pytest.fixture(scope="module")
def jax_loaders():
    """``tests/test_parallel.py``'s pools, labeled once."""
    import jax

    from generative_physics_informed_pde_tpu import fem as jfem
    from generative_physics_informed_pde_tpu.data import (
        DataLoader as JDataLoader)

    rf = jfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    dl = JDataLoader.from_sampler(rf, 24, key=jax.random.PRNGKey(2))
    dlu = JDataLoader.from_sampler(rf, 16, key=jax.random.PRNGKey(3))
    dlu.lock_physics_assembly()
    return dl, dlu


def _jax_trainer(loaders, case):
    """``tests/test_parallel.py``'s recipe with ``case``'s change, set up
    on ``make_mesh(4)`` (or the (4, 2) mesh) once: the trainer is built
    as ``CreateTrainerFromPermutation`` builds it, without its unsharded
    ``setup``."""
    from generative_physics_informed_pde_tpu.constraints import (
        vo_spec_preset)
    from generative_physics_informed_pde_tpu.parallel import make_mesh
    from generative_physics_informed_pde_tpu.training import (
        TrainerParameters)
    from generative_physics_informed_pde_tpu.training.trainer import (
        CreateDataSetsFromPermutation, Trainer)

    change = CASES[case][0]
    dl, dlu = loaders
    dl.reset_partition()
    dlu.reset_partition()
    p = TrainerParameters()
    p.identifier = "highres32"
    p.debug = True
    p.seed = 11
    p.trainer.update(lr_init=1e-2,
                     N_monte_carlo_elbo=change.get("n_mc", 1))
    p.scheduler = {"milestones": [50], "factor": 0.5}
    if change.get("energy"):
        p.trainer.update(N_vo_holdoff=0, N_vo_update_interval=2,
                         N_monte_carlo_vo=8)
        p.data.update(N_u=16, N_s=8, N_u_max=16, N_s_max=8, N_vo_max=8,
                      N_vo=8, N_val=8, armortized_bs=8,
                      vo_spec=vo_spec_preset(
                          "energy", T_iterations=8, N_rbf=4,
                          energy_num_iterations_per_update=2,
                          T_final=1e-2))
    else:
        p.data.update(N_u=16, N_s=16, N_u_max=16, N_s_max=16, N_vo_max=0,
                      N_vo=0, N_val=8, armortized_bs=8, vo_spec={})
    p.data.update(change["data"])
    if change.get("amortized") is False:
        p.data["armortized_bs"] = None
    tr = Trainer.FromIdentifier(p.identifier, p.margs, p.dargs,
                                debug=True, seed=p.seed)
    _, _, datasets = CreateDataSetsFromPermutation(
        p.identifier, np.arange(dl.N), np.arange(dlu.N), p.data["N_val"],
        p.data["N_u_max"], p.data["N_s_max"], p.data["N_vo_max"],
        tr.physics, None, tr.dtype, dl=dl, dlu=dlu)
    tr.set_data_from_datasets(
        dl, dlu, datasets, p.data["N_u"], p.data["N_s"], p.data["N_vo"],
        VO=None, vo_spec=p.data["vo_spec"],
        armortized_bs=p.data["armortized_bs"])
    tr.setup_config(**p.trainer)
    shape = _mesh_shape(case)
    mesh = make_mesh(4) if len(shape) == 1 \
        else make_mesh(8, ("dp", "mc"), shape)
    tr.setup(scheduler_spec=p.scheduler, mesh=mesh)
    return tr


@pytest.mark.parametrize("case", list(CASES))
def test_jax_package_refuses_or_trains(case, jax_loaders):
    import jax.numpy as jnp

    if not CASES[case][1]:
        with pytest.raises(ValueError, match="divisible by 4"):
            _jax_trainer(jax_loaders, case)
        return
    tr = _jax_trainer(jax_loaders, case)
    no_vo = (jnp.zeros((1, 1), dtype=tr._dtype),) * 2
    tr.state, logs = tr._train_step(tr.state, *no_vo, holdoff=False,
                                    n_steps=1)
    assert np.isfinite(float(logs["elbo"]))


@pytest.mark.parametrize("case", list(CASES))
def test_port_refuses_or_trains_where_the_jax_package_does(case, pools):
    change, trains = CASES[case]
    names = ("dp",) if len(_mesh_shape(case)) == 1 else ("dp", "mc")
    mesh = _StandIn(names, _mesh_shape(case))
    if not trains:
        with pytest.raises(ValueError, match="JAX package refuses"):
            _make_trainer(pools, 11, mesh=mesh, **change)
        return
    tr = _make_trainer(pools, 11, mesh=mesh, **change)
    assert tr._layout.k_rows == 4
    if case == "N_u_amortized":  # the unlabeled set stays whole
        assert tr._X_unsup.shape[0] == 14
    if case == "mc_rows":
        assert tr.model.mc_sharding is not None


# ------------------------------------------ two processes vs one process
@pytest.mark.parametrize("name", list(RUNS))
def test_uneven_run_on_two_processes_equals_one_process(name, children,
                                                        one_process):
    recs = children.records()
    ref = one_process[name][1]
    for r, rec in enumerate(recs):
        assert str(rec["backend"]) == "gloo"
        got = {k.split("/", 1)[1]: v for k, v in rec.items()
               if k.startswith(name + "/")}
        _assert_close(got, ref, f"{name} rank {r}")


def test_uneven_checkpoint_resumes_in_one_process(pools, children,
                                                  one_process, tmp_path):
    """The two processes' checkpoint after ``STEPS`` steps, resumed in one
    process for ``RESUMED_STEPS`` more, equals the unbroken run."""
    children.records()
    recipe = RUNS[CKPT_RUN][1]
    resumed = _make_trainer(pools, **recipe)
    resumed.restore_checkpoint(str(children.out / "uneven_ckpt.pt"))
    assert resumed.gn == STEPS
    unbroken = one_process[CKPT_RUN][0]
    for tr in (resumed, unbroken):
        for _ in range(RESUMED_STEPS):
            tr.step()
    ref = _record(unbroken)
    ref["elbo"] = ref["elbo"][-RESUMED_STEPS:]  # the resumed run's own
    _assert_close(_record(resumed), ref, "resumed")


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
           *sys.argv[6:7])
