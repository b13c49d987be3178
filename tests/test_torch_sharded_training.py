"""Sharded training of the port across processes equals the unsharded run.

The JAX package holds its sharded trainer to its unsharded one on 8
virtual devices (``tests/test_parallel.py::
test_sharded_training_matches_single_device`` and its siblings, and the
two-process lifecycle of ``tests/_dcn_child.py``); the port's unsharded
trainer is held to the JAX package's by ``tests/test_torch_training.py``
and ``tests/test_torch_resume.py``.  This file closes the chain for the
port: the same recipes (``_make_trainer``: 32^2 fields at correlation
length 0.15, 24 labeled + 16 unlabeled; ``_make_energy_vo_trainer``: 8
labeled, 8 energy-VO, 16 unlabeled), in f64, run by two gloo processes on
a mesh (this file run as a script with ``--child``; it imports no JAX and
needs no ``tests/conftest.py``) and held to the one-process unsharded run
in this process to 1e-9 of the scale:

- ``dp``: a dp=2 mesh, 3 steps; ``dp_options``: the same with the
  codec's channel dropout at 0.2 (masks drawn whole), fused decodes, an
  l2 penalty (counted by process 0) and ``normalize`` (by the global N),
  then with the non-amortized unlabeled term;
- ``mc``: a ("dp", "mc") mesh of (1, 2) with ``N_monte_carlo_elbo=4``, the
  Monte-Carlo batch split over 'mc', 3 steps; then the same mesh with one
  sample, where every batch repeats on the two replicas and the second
  counts none of the ELBO; ``dp_mc``: four processes on a (2, 2) mesh
  with four samples (rows split over dp, the Monte-Carlo rows over both);
- ``energy``: the energy-VO arm on dp=2, 5 steps: the temperature equal,
  the VO means and the q_z block;
- ``lifecycle``: ``tests/_dcn_child.py``'s lifecycle on a hybrid mesh
  (dcn=2 x dp=1): each process labels its own supervised rows (the
  others NaN) and the validation rows, 6 steps with a monitor point,
  save, restore, 2 more steps, finalize; the checkpoint written after 6
  steps restores into a one-process trainer with the same q_z block.

Every run ends with the generators' states equal to the one-process
run's, bit for bit.  Each case's children run under a timeout of their
own and are killed on expiry.  A one-device mesh equals ``setup()`` bit
for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from generative_physics_informed_pde_tpu_torch import fem, parallel  # noqa: E402
from generative_physics_informed_pde_tpu_torch.data import DataLoader  # noqa: E402
from generative_physics_informed_pde_tpu_torch.training import (  # noqa: E402
    CreateTrainerFromPermutation, TrainerParameters)

RTOL = 1e-9
CHILD_TIMEOUT = 150
SIGNALS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
           "LOCAL_WORLD_SIZE", "LOCAL_RANK")
# case -> its processes, its mesh and the runs its children make in turn
# ({record prefix: _make_trainer's recipe and the steps})
CASES = {
    "dp": dict(procs=2, mesh="dp", runs={"": dict(seed=11, steps=3)}),
    "dp_options": dict(procs=2, mesh="dp", runs={
        "": dict(seed=11, steps=3,
                 margs={"droprate": 0.2, "fuse_decodes": True},
                 trainer={"l2_penalty": 1e-3, "normalize": True}),
        "non_amortized/": dict(seed=11, steps=3, margs={"droprate": 0.2},
                               trainer={"normalize": True},
                               amortized=False)}),
    "mc": dict(procs=2, mesh="mc", runs={
        "": dict(seed=13, steps=3, n_mc=4),
        "n1/": dict(seed=13, steps=3)}),
    "dp_mc": dict(procs=4, mesh="dp_mc",
                  runs={"": dict(seed=13, steps=3, n_mc=4)}),
    "energy": dict(procs=2, mesh="dp",
                   runs={"": dict(seed=17, steps=5, energy=True)}),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_pools():
    """The recipe's fields: 24 labeled (key 2), 16 unlabeled (key 3)."""
    rf = fem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    return (DataLoader.from_sampler(rf, 24, key=2, device="cpu").X,
            DataLoader.from_sampler(rf, 16, key=3, device="cpu").X)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """The pools, and a file of them for the children (drawing them again
    there would cost each child a 1024^2 Cholesky)."""
    X, Xu = _draw_pools()
    path = tmp_path_factory.mktemp("pools") / "pools.npz"
    np.savez(path, X=X, Xu=Xu)
    return X, Xu, path


def _loaders(pools, rows=None):
    """Loaders of the pools; the labels of ``rows`` (default all) solved
    in dispatches of 8 (the loader's default of 256 would pad 24 fields
    to 256), the others NaN."""
    X, Xu = pools[:2]
    dl = DataLoader(X)
    dl.assemble(fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu"),
                label_batch=8, rows=rows)
    dlu = DataLoader(Xu)
    dlu.lock_physics_assembly()
    return dl, dlu


def _make_trainer(pools, seed, n_mc=1, margs=None, energy=False,
                  mesh=None, loaders=None, iters=8, device="cpu",
                  trainer=None, amortized=True, data=None):
    """``tests/test_parallel.py``'s ``_make_trainer`` (or, with
    ``energy``, its ``_make_energy_vo_trainer``) on the port, in f64;
    ``trainer``: more trainer config, ``amortized=False``: the
    non-amortized unlabeled term, ``data``: other data sizes."""
    from generative_physics_informed_pde_tpu_torch.constraints import (
        vo_spec_preset)

    dl, dlu = loaders or _loaders(pools)
    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs.update({"dtype": "float64", **(margs or {})})
    p.debug = True
    p.seed = seed
    p.trainer.update(lr_init=1e-2, N_monte_carlo_elbo=n_mc,
                     **(trainer or {}))
    p.scheduler = {"milestones": [50], "factor": 0.5}
    if energy:
        p.trainer.update(N_vo_holdoff=0, N_vo_update_interval=2,
                         N_monte_carlo_vo=8)
        p.data.update(N_u=16, N_s=8, N_u_max=16, N_s_max=8, N_vo_max=8,
                      N_vo=8, N_val=8, armortized_bs=8,
                      vo_spec=vo_spec_preset(
                          "energy", T_iterations=iters, N_rbf=4,
                          energy_num_iterations_per_update=2,
                          T_final=1e-2))
    else:
        p.data.update(N_u=16, N_s=16, N_u_max=16, N_s_max=16, N_vo_max=0,
                      N_vo=0, N_val=8, armortized_bs=8 if amortized else None,
                      vo_spec={})
    p.data.update(data or {})
    tr = CreateTrainerFromPermutation(
        p, permutation=np.arange(dl.N), permutation_u=np.arange(dlu.N),
        dl=dl, dlu=dlu, device=device)
    if mesh is not None:
        tr.setup(scheduler_spec=p.scheduler, mesh=mesh)
    return tr


def _record(tr, mesh=None):
    """What a run is compared on, whole, as numpy."""
    def whole(x):
        x = x.detach()
        return (x if mesh is None
                else parallel.gather_batch(x, mesh)).cpu().numpy()

    out = {"q_z": whole(tr.model.q_z["supervised"]["mean"]),
           "q_z_logsigma": whole(tr.model.q_z["supervised"]["logsigma"]),
           "q_X": whole(tr.model.q_X["supervised"]["mean"]),
           "pe_q": whole(tr._PE.q["mean"]),
           "elbo": tr.elbos().numpy(),
           "generator": tr.generator.get_state().numpy(),
           "vo_generator": tr.vo_generator.get_state().numpy()}
    for name, t in tr.model.named_parameters():
        if name.split(".", 1)[0] not in ("q_z", "q_X"):
            out["param/" + name] = t.detach().cpu().numpy()
    for name, t in tr.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            out["buffer/" + name] = t.cpu().numpy()
    if tr.VO is not None:
        out["vo_mean"] = whole(tr.VO.mean)  # this process's VO rows
        if hasattr(tr.VO, "temperature"):  # the energy arm
            out["vo_temperature"] = np.asarray(tr.VO.temperature)
    return out


def _assert_close(got, ref, what=""):
    assert sorted(got) == sorted(ref), what
    for k, v in ref.items():
        g = got[k]
        assert g.shape == v.shape, (what, k)
        if k.endswith("generator") or k == "vo_temperature":
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
            continue
        scale = max(np.abs(v).max(), 1e-300)
        err = np.abs(g - v).max() / scale
        assert np.isfinite(g).all() and err <= RTOL, (what, k, err)


# ------------------------------------------------------------ the children
def _child_mesh(kind, world, device):
    if kind == "mc":
        return parallel.make_mesh(2, ("dp", "mc"), (1, 2), device=device)
    if kind == "dp_mc":
        return parallel.make_mesh(world, ("dp", "mc"), (world // 2, 2),
                                  device=device)
    if kind == "hybrid":
        return parallel.make_hybrid_mesh(("dp",), device=device)
    return parallel.make_mesh(device=device)


def _child(case: str, rank: int, world: int, init: str, out: str,
           device: str = "cpu") -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert parallel.initialize(f"file://{init}", world, rank, device=device)
    with np.load(os.path.join(out, "pools.npz")) as f:
        pools = (f["X"], f["Xu"])
    if case == "lifecycle":
        rec = _lifecycle(pools, _child_mesh("hybrid", world, device), out)
    else:
        mesh = _child_mesh(CASES[case]["mesh"], world, device)
        rec = run_case(case, pools, mesh, device)
        rec["backend"] = np.asarray(dist.get_backend())
    np.savez(os.path.join(out, f"{case}.rank{rank}.npz"), **rec)
    dist.destroy_process_group()


def _lifecycle(pools, mesh, out):
    """``tests/_dcn_child.py``'s lifecycle: per-process labels, 6 steps
    (a monitor point at step 5), save, restore, 2 steps, finalize."""
    assert mesh.mesh_dim_names == ("dcn", "dp") and mesh.shape == (2, 1)
    n_sup, n = 16, 24
    sup_rows = np.arange(n_sup)[parallel.local_shard_slice(n_sup)]
    my_rows = np.r_[sup_rows, np.arange(n_sup, n)]
    dl, dlu = _loaders(pools, rows=my_rows)
    other = np.setdiff1d(np.arange(dl.N), my_rows)
    assert np.isnan(dl.Y[other]).all() and np.isfinite(dl.Y[my_rows]).all()
    tr = _make_trainer(pools, 11, mesh=mesh, loaders=(dl, dlu))
    assert torch.isfinite(tr._data_sup["Y"]).all()
    tr.run(6, verbose=False)
    assert tr._monitor["elbo"] and tr._analysis.series["r2_y"].value
    ckpt = os.path.join(out, "lifecycle_ckpt.pt")
    q_before = parallel.gather_batch(
        tr.model.q_z["supervised"]["mean"].detach(), mesh)
    tr.save_checkpoint(ckpt)
    tr.restore_checkpoint(ckpt)
    q_after = parallel.gather_batch(
        tr.model.q_z["supervised"]["mean"].detach(), mesh)
    assert torch.equal(q_before, q_after)
    assert tr.model.q_z["supervised"]["mean"].shape[0] == n_sup // 2
    tr.run(2, verbose=False)
    tr.finalize()
    rec = _record(tr, mesh)
    rec["monitor_elbo"] = np.asarray(tr._monitor["elbo"])
    rec["r2"] = np.asarray(tr._analysis.series["r2_y"].value)
    rec["q_saved"] = q_before.numpy()
    return rec


def _run_children(case, pools, tmp_path, world=2, device="cpu"):
    """``world`` processes of ``case`` on ``device`` (the card: one a card,
    nccl), killed after CHILD_TIMEOUT s -> each one's record."""
    import shutil

    shutil.copy(pools[2], tmp_path / "pools.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for k in SIGNALS:
        env.pop(k, None)
    if case == "lifecycle":
        env["LOCAL_WORLD_SIZE"] = "1"  # one process a node: dcn = 2
    init = tmp_path / f"init_{case}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", case, str(r), str(world),
         str(init), str(tmp_path), device], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    for pr in procs:
        try:
            o, _ = pr.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = pr.communicate()
        outs.append(o)
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r} failed:\n{outs[r][-4000:]}"
    return [dict(np.load(tmp_path / f"{case}.rank{r}.npz"))
            for r in range(world)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_run_equals_one_process(case, pools, tmp_path):
    recs = _run_children(case, pools, tmp_path, CASES[case]["procs"])
    ref = one_process_record(case, pools)
    for r, rec in enumerate(recs):
        assert str(rec.pop("backend")) == "gloo"
        _assert_close(rec, ref, f"{case} rank {r}")
    if "vo_temperature" in ref:  # the energy arm's temperature moved
        assert ref["vo_temperature"] < 1.0
        assert np.isfinite(ref["vo_mean"]).all()


def run_case(case, pools, mesh=None, device="cpu"):
    """The runs of ``case`` on ``mesh`` (None: unsharded, in this
    process) -> their records, each under its prefix."""
    out = {}
    for prefix, run in CASES[case]["runs"].items():
        run = dict(run)
        steps = run.pop("steps")
        tr = _make_trainer(pools, mesh=mesh, device=device, **run)
        if mesh is not None:  # the Monte-Carlo batch split over 'mc'
            assert (tr.model.mc_sharding is not None) == (
                run.get("n_mc", 1) > 1 and "mc" in mesh.mesh_dim_names)
        for _ in range(steps):
            tr.step()
        out.update({prefix + k: v for k, v in _record(tr, mesh).items()})
    return out


def one_process_record(case, pools, device="cpu"):
    """``case`` run unsharded in this process on ``device``."""
    return run_case(case, pools, None, device)


def test_two_process_lifecycle_equals_one_process(pools, tmp_path):
    recs = _run_children("lifecycle", pools, tmp_path)
    tr = _make_trainer(pools, 11)
    tr.run(6, verbose=False)
    q_saved = tr.model.q_z["supervised"]["mean"].detach().numpy().copy()
    path = tr.save_checkpoint(str(tmp_path / "one.pt"))
    tr.restore_checkpoint(path)
    tr.run(2, verbose=False)
    tr.finalize()
    ref = _record(tr)
    ref["monitor_elbo"] = np.asarray(tr._monitor["elbo"])
    ref["r2"] = np.asarray(tr._analysis.series["r2_y"].value)
    ref["q_saved"] = q_saved
    for r, rec in enumerate(recs):
        _assert_close(rec, ref, f"lifecycle rank {r}")
    # the two processes' checkpoint restores into one process
    one = _make_trainer(pools, 11)
    one.restore_checkpoint(str(tmp_path / "lifecycle_ckpt.pt"))
    np.testing.assert_array_equal(
        one.model.q_z["supervised"]["mean"].detach().numpy(),
        recs[0]["q_saved"])
    assert one.gn == 6


def test_one_device_mesh_equals_setup_bit_for_bit(pools):
    """``setup(mesh=make_mesh(1))`` runs the sharded path on one device:
    the same parameters, statistics, Adam state and generator, exactly."""
    plain = _make_trainer(pools, 11, margs={"droprate": 0.2})
    mesh = parallel.make_mesh(1, device="cpu")
    sharded = _make_trainer(pools, 11, margs={"droprate": 0.2}, mesh=mesh)
    assert sharded._layout is not None and plain._layout is None
    plain.run(6, verbose=False)
    sharded.run(6, verbose=False)
    a, b = _record(plain), _record(sharded)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert plain._monitor == sharded._monitor
    sa, sb = plain.optimizer.state_dict(), sharded.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
           sys.argv[6], *sys.argv[7:8])
