"""Resume of the port's trainer on the CPU, in f64, held bit for bit.

The training draws come from ``trainer.generator`` alone; every monitor
point and the final refinement and analysis draw from a generator seeded
from ``(seed + c, gn)``.  So ``run(4); run(2)`` equals ``run(6)``, and a
checkpoint written after 4 steps, restored into a fresh trainer and run
for 2 more equals the unbroken 6: parameters, BatchNorm statistics and
Adam's state, exactly.  The JAX package's tests of the same properties
(``tests/test_inference_extra.py`` ``test_trainer_checkpoint_roundtrip``,
``test_plateau_state_checkpoint_roundtrip``; ``tests/test_training.py``
``test_trainer_vo_checkpoint_resume``) hold its resume to rtol 1e-6; the
port, compared with itself, is held exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters, restore_encoder_decoder,
    restore_train_state, save_encoder_decoder, save_train_state)


@pytest.fixture(scope="module")
def pools():
    """16 labeled (labels solved once) and 8 unlabeled 32^2 fields."""
    return _draw_pools()


def _draw_pools():
    rf = fem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = rf.sample(torch.Generator().manual_seed(0), batch_size=24,
                  dtype=torch.float64, device="cpu").numpy()
    dl = DataLoader(X[:16])
    dl.assemble(fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu"))
    return dl, X[16:]


def _params(scheduler=None, **data):
    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs["dtype"] = "float64"
    p.debug = True  # monitor every 5 steps, short PE refinements
    p.trainer["lr_init"] = 1e-2
    p.scheduler = scheduler or {"milestones": [50], "factor": 0.5}
    p.data.update(N_u=8, N_s=8, N_u_max=8, N_s_max=8, N_vo_max=0, N_vo=0,
                  N_val=4, armortized_bs=4, vo_spec={})
    p.data.update(data)
    return p


def _make(pools, p):
    dl, Xu = pools
    dlu = DataLoader(Xu)
    dlu.lock_physics_assembly()
    return CreateTrainer(p, DataLoader(dl.X, X_DG=dl.X_DG, Y=dl.Y,
                                       BCE=dl.BCE, F_ROM_BC=dl.F_ROM_BC),
                         dlu, device="cpu")


def _flat(tree, prefix=""):
    """(name, tensor or number) leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_identical(a, b):
    la, lb = list(_flat(a)), list(_flat(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def _training_state(tr):
    return {"model": tr.model.state_dict(),
            "adam": tr.optimizer.state_dict(),
            "generator": tr.generator.get_state()}


def test_split_run_equals_unbroken_run(pools):
    """The fault this file guards: the monitor and final draws came from
    the training generator, so run(4); run(2) left run(6)'s trajectory
    (2.28e-2 in the parameters)."""
    split, straight = _make(pools, _params()), _make(pools, _params())
    split.run(4, verbose=False)
    split.run(2, verbose=False)
    straight.run(6, verbose=False)
    assert split.gn == straight.gn == 6
    _assert_identical(_training_state(split), _training_state(straight))
    assert any(name.endswith("running_mean")
               for name in split.model.state_dict())


def test_checkpoint_restore_continue_equals_unbroken(pools, tmp_path):
    """Port of ``test_trainer_checkpoint_roundtrip``: the checkpoint
    round-trips every piece of state exactly, a fresh trainer restored
    from it continues as the unbroken run, and the file holds plain
    containers only (``weights_only`` loading)."""
    tr = _make(pools, _params())
    tr.run(4, verbose=False)
    path = tr.save_checkpoint(str(tmp_path / "ckpt.pt"))
    saved = restore_train_state(path)
    assert saved["gn"] == 4 and saved["device_type"] == "cpu"
    assert "plateau" not in saved

    fresh = _make(pools, _params())
    with torch.no_grad():
        for prm in fresh.model.parameters():
            prm.zero_()
    fresh.restore_checkpoint(path)
    assert fresh.gn == 4 and fresh._global_runtime == tr._global_runtime
    _assert_identical(_training_state(fresh), _training_state(tr))
    _assert_identical(fresh._PE.state_dict(), tr._PE.state_dict())
    assert torch.equal(fresh.vo_generator.get_state(),
                       tr.vo_generator.get_state())
    assert fresh._monitor == tr._monitor

    fresh.run(2, verbose=False)
    straight = _make(pools, _params())
    straight.run(6, verbose=False)
    assert fresh.gn == 6
    _assert_identical(_training_state(fresh), _training_state(straight))


def test_monitor_series_and_tinfo(pools, capsys):
    """The monitor series are filled at the monitor points (every 5 steps
    in debug mode) with the ELBO and the learning rate."""
    tr = _make(pools, _params())
    tr.run(11, verbose=False)
    assert tr._monitor["elbo_iter"] == tr._monitor["lr_iter"] == [6, 11]
    elbos = tr.elbos().numpy()
    assert tr._monitor["elbo"] == [elbos[5], elbos[10]]
    assert tr._monitor["lr"] == [1e-2, 1e-2]
    tr.tinfo(100)
    out = capsys.readouterr().out
    assert "11 iterations in" in out and "for 100 iterations" in out


PLATEAU = {"patience": 0, "factor": 0.5, "min_lr": 1e-4,
           "threshold": 1e12}  # never an improvement: decay at each point


def test_plateau_state_checkpoint_roundtrip(pools, tmp_path):
    """Port of ``test_plateau_state_checkpoint_roundtrip``: the
    controller's scale, best and bad steps ride in the checkpoint, so the
    next monitor point does not snap the lr back; a checkpoint written
    without plateau state leaves the controller as it is."""
    tr = _make(pools, _params(PLATEAU))
    tr.run(12, verbose=False)
    scale = tr._plateau.scale
    assert scale < 1.0
    path = tr.save_checkpoint(str(tmp_path / "ckpt.pt"))

    tr2 = _make(pools, _params(PLATEAU))
    tr2.restore_checkpoint(path)
    assert (tr2._plateau.scale, tr2._plateau.best, tr2._plateau.bad_steps) \
        == (scale, tr._plateau.best, tr._plateau.bad_steps)
    tr2.run(5, verbose=False)
    assert tr2.lr(tr2.gn) <= 1e-2 * scale
    assert [g["lr"] for g in tr2.optimizer.param_groups] \
        == [tr2.lr(tr2.gn)]

    old = restore_train_state(path)
    del old["plateau"]
    older = save_train_state(str(tmp_path / "older.pt"), old)
    tr3 = _make(pools, _params(PLATEAU))
    tr3.restore_checkpoint(older)
    assert tr3.gn == 12 and tr3._plateau.scale == 1.0


def test_vo_checkpoint_resume_reconditions(pools, tmp_path):
    """Port of ``test_trainer_vo_checkpoint_resume``: the first step
    after a restore reconditions the VO posterior (the checkpoint keeps
    the ensemble's state to recondition from) and the run stays
    finite."""
    spec = {"type": "constrain", "CGR": True, "flux": True,
            "N_gaussian": 2, "N_rbf": 2, "l_rbf": 0.2}

    def params():
        p = _params(N_vo=4, N_vo_max=4, N_s=6, N_s_max=6, vo_spec=spec)
        p.trainer.update(N_vo_holdoff=3, N_vo_update_interval=5)
        return p

    tr = _make(pools, params())
    tr.run(12, verbose=False)
    assert tr._vo_is_initialized
    path = tr.save_checkpoint(str(tmp_path / "ck.pt"))
    tr2 = _make(pools, params())
    tr2.restore_checkpoint(path)
    assert tr2.gn == 12 and not tr2._vo_is_initialized
    assert torch.equal(tr2.vo_generator.get_state(),
                       tr.vo_generator.get_state())
    refreshes = []
    refresh = tr2.update_virtual_observables
    tr2.update_virtual_observables = lambda step: (refreshes.append(step),
                                                   refresh(step))
    tr2.run(6, verbose=False)
    assert refreshes == [12, 15] and tr2._vo_is_initialized
    assert bool(torch.isfinite(tr2.VO.mean).all())
    assert bool(torch.isfinite(tr2.elbos()).all())
    assert np.isfinite(tr2.results()["logscore_y"])


ENERGY = {"type": "energy", "l_rbf": 0.2, "N_rbf": 4,
          "energy_num_iterations_per_update": 2, "T_init": 1.0,
          "T_final": 1e-2, "T_iterations": 20}


def _energy_params():
    p = _params(N_vo=4, N_vo_max=4, N_s=6, N_s_max=6, vo_spec=ENERGY)
    p.trainer.update(N_vo_holdoff=2, N_vo_update_interval=3)
    return p


def _resume_energy(pools, path, steps: int) -> dict:
    """A fresh energy-VO trainer restored from ``path``: the VO state it
    restored, the steps it refreshed at in ``steps`` more, its state
    after them."""
    tr = _make(pools, _energy_params())
    tr.restore_checkpoint(path)
    restored = {k: v.clone() for k, v in tr.VO.moments().items()}
    initialized = tr._vo_is_initialized
    refreshes = []
    refresh = tr.update_virtual_observables
    tr.update_virtual_observables = lambda step: (refreshes.append(step),
                                                  refresh(step))
    tr.run(steps, verbose=False)
    return {"restored": restored, "initialized": initialized,
            "refreshes": refreshes, "vo_mean": tr.VO.mean,
            "elbos": tr.elbos(), "state": _training_state(tr)}


def test_vo_state_resumes_in_a_fresh_process(pools, tmp_path):
    """The checkpoint keeps the VO state, which the JAX package's leaves
    out (its resume reconditions from a fresh ensemble): a new process
    restores the energy arm's iterate from the file bit for bit,
    reconditions it on its first step all the same, and continues as a
    fresh trainer restored in this process does."""
    tr = _make(pools, _energy_params())
    tr.run(7, verbose=False)  # refreshes at 2 (the first chance), 3, 6
    path = tr.save_checkpoint(str(tmp_path / "ck.pt"))
    out = tmp_path / "fresh.pt"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--resume-energy", path, str(out),
                    str(torch.get_num_threads())], check=True, timeout=300,
                   env=env)
    there = torch.load(out)
    here = _resume_energy(pools, path, 3)
    for got in (there, here):
        assert not got["initialized"]
        assert got["refreshes"] == [7, 9]  # the first step, then 3k
        assert set(got["restored"]) == {"mean", "vars"}
        assert torch.equal(got["restored"]["mean"], tr.VO.mean)
        assert torch.equal(got["restored"]["vars"], tr.VO.vars)
        assert not torch.equal(got["vo_mean"], tr.VO.mean)
        assert bool(torch.isfinite(got["elbos"]).all())
    _assert_identical(there["state"], here["state"])
    assert torch.equal(there["vo_mean"], here["vo_mean"])


def test_checkpoint_from_another_device_type_is_refused(pools, tmp_path):
    """A generator's state belongs to its device type: a checkpoint from
    a card is refused on the CPU with a clear error, never restored with
    fresh draws; the codec's parameters still load through
    ``restore_encoder_decoder``."""
    tr = _make(pools, _params())
    tr.run(2, verbose=False)
    state = restore_train_state(tr.save_checkpoint(str(tmp_path / "a.pt")))
    state["device_type"] = "cuda"
    path = save_train_state(str(tmp_path / "b.pt"), state)
    fresh = _make(pools, _params())
    before = fresh.generator.get_state()
    with pytest.raises(ValueError, match="written by a trainer on 'cuda'"):
        fresh.restore_checkpoint(path)
    assert torch.equal(fresh.generator.get_state(), before)

    codec = save_encoder_decoder(str(tmp_path / "codec.pt"), tr.model)
    assert set(restore_train_state(codec)) == {"f", "encoder"}
    restore_encoder_decoder(codec, fresh.model)
    for part in ("f", "encoder"):
        _assert_identical(getattr(fresh.model, part).state_dict(),
                          getattr(tr.model, part).state_dict())


if __name__ == "__main__" and sys.argv[1:2] == ["--resume-energy"]:
    torch.set_num_threads(int(sys.argv[4]))
    torch.save(_resume_energy(_draw_pools(), sys.argv[2], 3), sys.argv[3])
