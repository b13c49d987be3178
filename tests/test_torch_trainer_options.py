"""The trainer's and the parallel layer's options that the port took over
from the JAX package: ``Trainer.run(profile_dir=)``,
``CreateTrainerFromPermutation(BCE_encoding=)``,
``Trainer.FromIdentifier(dargs=)``, ``DataFactory(config=)``,
``minibatch_indices(replace=)``, ``initialize(local_device_ids=)`` and
``Trainer.export_surrogate(platforms=)``.

``BCE_encoding`` is held against the JAX package in f64 on the highres32
preset: the labeled pool and its encodings are numpy arrays given to both
packages (no preset ``setup()``), the labels and ``F_ROM_BC`` of both
chunks agree to 1e-10 (two PCG solves to 1e-10), and the first ELBO, from
the JAX trainer's initial state carried across by ``convert.py`` with the
draws injected into both packages, to 1e-8 (convolution sums in another
order).
"""

import glob
import json
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.data import DataLoader as JDataLoader
from generative_physics_informed_pde_tpu.factories import data as jdf
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.training import trainer as jtrainer
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch import parallel
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.data.sampling import (
    minibatch_indices)
from generative_physics_informed_pde_tpu_torch.factories import data as tdf
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.serving import SurrogateBundle
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

N_S, N_VAL, N_U = 6, 4, 4
LABEL_RTOL = 1e-10
ELBO_RTOL = 1e-8


def _fields(n, seed):
    rf = tfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    return rf.sample(torch.Generator().manual_seed(seed), batch_size=n,
                     dtype=torch.float64, device="cpu").numpy()


def _params(params_cls, **data):
    p = params_cls()
    p.identifier = "highres32"
    p.margs["dtype"] = "float64"
    p.trainer.update(lr_init=1e-2, N_PE_updates=0, N_monitor_interval=0)
    p.data.update(N_u=0, N_s=N_S, N_u_max=0, N_s_max=N_S, N_val=N_VAL,
                  **data)
    return p


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ------------------------------------------- profile_dir, export platforms
@pytest.fixture(scope="module")
def small_trainer():
    X = _fields(20, seed=8)
    p = TrainerParameters()
    p.identifier = "highres32"
    p.trainer.update(lr_init=1e-2, N_monitor_interval=0, N_PE_updates=0,
                     N_PE_updates_final=0)
    p.data.update(N_u=8, N_s=8, N_u_max=8, N_s_max=8, N_val=4,
                  armortized_bs=4)
    dlu = DataLoader(X[12:])
    dlu.lock_physics_assembly()
    return CreateTrainer(p, DataLoader(X[:12]), dlu, device="cpu")


def test_run_writes_a_profiler_trace_and_stops_it_when_the_loop_raises(
        small_trainer, tmp_path):
    tr = small_trainer
    gn = tr.gn
    tr.run(2, verbose=False, profile_dir=str(tmp_path / "a"))
    traces = glob.glob(str(tmp_path / "a" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)  # host activity of the steps
    assert not torch.autograd._profiler_enabled()
    assert tr.gn == gn + 2

    def boom(n, gn):
        raise KeyboardInterrupt("stop")

    with pytest.raises(KeyboardInterrupt):
        tr.run(3, verbose=False, callback=boom,
               profile_dir=str(tmp_path / "b"))
    assert not torch.autograd._profiler_enabled()
    assert len(glob.glob(str(tmp_path / "b" / "*.pt.trace.json"))) == 1
    # a later profiled run starts: the first one did not leak
    tr.run(1, verbose=False, profile_dir=str(tmp_path / "c"))
    assert len(glob.glob(str(tmp_path / "c" / "*.pt.trace.json"))) == 1
    assert tr.gn == gn + 4


def test_trainer_exports_for_the_platforms_asked_for(small_trainer,
                                                     tmp_path):
    path = str(tmp_path / "s.zip")
    bundle = small_trainer.export_surrogate(path, buckets=(8,),
                                            platforms=("cpu",))
    assert bundle.platforms == ("cpu",)
    loaded = SurrogateBundle.load(path, device="cpu")
    assert loaded.platforms == ("cpu",)
    rng = np.random.default_rng(9)
    x, F = rng.normal(0.4, 0.8, (5, 32, 32)), rng.uniform(-0.5, 0.5, (5, 25))
    assert torch.equal(loaded.predict(x, F), bundle.predict(x, F))


# --------------------------------------------------------- BCE_encoding
class Draws:
    """Standard normals in call order from one numpy seed."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape))


def _inject(monkeypatch, seed):
    dj, dt = Draws(seed), Draws(seed)

    def j_sample(params, key):
        eps = jnp.asarray(dj.normal(params["logsigma"].shape))
        return params["mean"] + jnp.exp(params["logsigma"]) * eps

    def j_reparametrize(key, mean, logsigma):
        return mean + jnp.exp(logsigma) * jnp.asarray(
            dj.normal(logsigma.shape))

    def t_sample(params, generator=None):
        eps = torch.as_tensor(dt.normal(params["logsigma"].shape))
        return params["mean"] + torch.exp(params["logsigma"]) * eps

    def t_reparametrize(generator, mean, logsigma):
        return mean + torch.exp(logsigma) * torch.as_tensor(
            dt.normal(logsigma.shape))

    monkeypatch.setattr(jva, "sample", j_sample)
    monkeypatch.setattr(jgen, "reparametrize", j_reparametrize)
    monkeypatch.setattr(tva, "sample", t_sample)
    monkeypatch.setattr(tgen, "reparametrize", t_reparametrize)


def test_bce_encoding_matches_jax(monkeypatch):
    X = _fields(N_S + N_VAL + N_U, seed=3)
    X_lab, X_u = X[:N_S + N_VAL], X[N_S + N_VAL:]
    enc = tfem.BoundaryConditionEnsemble.from_factory(
        "NDP", N_S + N_VAL, np.random.default_rng(4)).encode()
    enc[:, 0] += 0.25  # not a draw the loaders would make themselves
    perm = np.random.default_rng(5).permutation(N_S + N_VAL)
    perm_u = np.arange(N_U)

    jtr = jtrainer.CreateTrainerFromPermutation(
        _params(jtrainer.TrainerParameters), perm, perm_u,
        dl=JDataLoader(X_lab), dlu=JDataLoader(X_u), BCE_encoding=enc)
    ttr = ttrainer.CreateTrainerFromPermutation(
        _params(TrainerParameters), perm, perm_u, dl=DataLoader(X_lab),
        dlu=DataLoader(X_u), BCE_encoding=enc, device="cpu")
    np.testing.assert_array_equal(ttr.dl.BCE.encode(), enc)
    np.testing.assert_array_equal(np.asarray(jtr.dl.BCE.encode()), enc)
    for chunk in ("supervised", "validation"):
        for key in ("Y", "F_ROM_BC"):
            got = ttr.datasets[chunk].get(key).numpy()
            want = np.asarray(jtr.datasets[chunk].get(key))
            assert got.dtype == np.float64
            assert _rel(got, want) <= LABEL_RTOL, (chunk, key)

    params = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    bs = jax.tree_util.tree_map(np.asarray, jtr.state.batch_stats)
    load_flax_variables(ttr.model, params, bs)
    _inject(monkeypatch, 11)
    sup = jtr.datasets["supervised"]
    data = {"supervised": {k: jnp.asarray(sup.get(k))
                           for k in ("X", "Y", "F_ROM_BC")}}
    elbo_j, _, _ = jtr.model.elbo(jtr.state.params, jtr.state.batch_stats,
                                  data, jax.random.PRNGKey(0))
    ttr.step()
    assert _rel(ttr.elbos()[0].item(), float(elbo_j)) <= ELBO_RTOL
    assert np.isfinite(float(elbo_j))


# ------------------------------------------------ the smaller keywords
def _warning_of(cls, **kw):
    class Bare(cls):  # FromIdentifier without building a trainer
        def __init__(self, **kwargs):
            pass

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Bare.FromIdentifier("highres32", **kw)
    return [str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]


def test_dargs_warns_as_the_jax_package_does():
    want = _warning_of(jtrainer.Trainer, dargs={"N": 3})
    assert len(want) == 1
    assert _warning_of(ttrainer.Trainer, dargs={"N": 3}) == want
    assert _warning_of(ttrainer.Trainer) == _warning_of(ttrainer.Trainer,
                                                        dargs={}) == []


def test_data_factory_keeps_its_config():
    config = {"N": 4}
    for factory in (jdf.DataFactory, tdf.DataFactory):
        assert factory(config).config is config
        assert factory().config is None
    assert tdf.DataFactory(config, path="somewhere/").path == \
        tdf.DataFactory(path="somewhere/").path


def test_minibatch_indices_with_and_without_replacement():
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    # without replacement: the draws of before the keyword, bit for bit
    assert torch.equal(minibatch_indices(g1, 10, 6),
                       torch.randperm(10, generator=g2)[:6])
    idx = minibatch_indices(g1, 10, 40, replace=True)
    want = torch.randint(10, (40,), generator=g2)
    assert torch.equal(idx, want) and idx.shape == (40,)
    assert int(idx.min()) >= 0 and int(idx.max()) < 10
    assert len(set(idx.tolist())) < 40  # repeats: with replacement
    assert minibatch_indices(None, 5, 3, device="cpu",
                             replace=True).shape == (3,)


def test_initialize_refuses_local_device_ids_off_a_card(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="must be None"):
        parallel.initialize(local_device_ids=[0], device="cpu")
    with pytest.raises(ValueError, match="one card"):
        parallel.initialize(local_device_ids=[0, 1], device="cuda")
    assert parallel.initialize(local_device_ids=None, device="cpu") is False
    assert not torch.distributed.is_initialized()
