"""The port's BASELINE runner (``examples/torch_baseline_configs.py``)
against the JAX package's (``examples/baseline_configs.py``).

1. Every config builds the same recipe: each module's ``_loaders`` and
   ``_run`` are replaced by recorders, the config function is called, and
   the recorded trainer parameters (identifier, model, trainer, scheduler
   and data tiers, the VO spec included), random field, pool sizes,
   iterations, checkpoint directory and segment are held equal.  Nothing
   is labelled or trained.
2. A 32^2 stand-in of config 2 (the 'highres' preset with an 4^2 ROM
   refined 3 times and decoder blocks (1, 2); the 'constrain' VO spec,
   channel dropout 0.2, the amortized unlabeled term; pools cut to 6
   supervised, 4 VO, 4 validation and 8 unlabeled fields, 4 VO Monte-Carlo
   samples, holdoff 1 and interval 2 so that two refreshes fall in three
   steps) takes three f64 SVI steps in both packages under injected draws
   (``tests/test_torch_vo_training.py``'s streams and
   ``tests/test_torch_dropout.py``'s channel masks; each JAX step traced
   afresh) and is held to 1e-7: ELBOs, parameters, BatchNorm statistics
   and the VO moments, as the port's other three-step tests.
"""

import copy
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.constraints import (
    virtual_observables as jvo)
from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import components as jcomp
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.constraints import (
    virtual_observables as tvo)
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import codec as tcodec
from generative_physics_informed_pde_tpu_torch.models import components as tcomp
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import CreateTrainer
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _module(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runners():
    return _module("baseline_configs"), _module("torch_baseline_configs")


def _record(monkeypatch, mod):
    rec = {}

    def loaders(rf, n_labeled, n_unlabeled, seed=0, **kw):
        rec.update(rf=rf, pools=(n_labeled, n_unlabeled, seed))
        return "dl", "dlu"

    def run(params, dl, dlu, iterations, ckpt_dir=None, seg=None, **kw):
        assert (dl, dlu) == ("dl", "dlu")
        rec.update(params=params, iterations=iterations, ckpt_dir=ckpt_dir,
                   seg=seg)

    monkeypatch.setattr(mod, "_loaders", loaders)
    monkeypatch.setattr(mod, "_run", run)
    return rec


RF_FIELDS = ("mean", "stddev", "corrlength", "truncation", "py", "px",
             "method", "kernel")
PARAM_FIELDS = ("identifier", "margs", "trainer", "scheduler", "data",
                "optimizer", "folder", "comment", "debug", "Iterations",
                "seed")
CASES = [("1", ()), ("2", ()), ("2", (3000, 250)), ("2e", ()), ("2h", ()),
         ("2he", ()), ("2he", (800,)), ("3", ()), ("3", (3000,)), ("4", ()),
         ("512", ())]


@pytest.mark.parametrize("which,args", CASES,
                         ids=[f"{w}-{'-'.join(map(str, a)) or 'default'}"
                              for w, a in CASES])
def test_every_config_builds_the_jax_recipe(runners, monkeypatch, which,
                                            args):
    jmod, tmod = runners
    assert list(tmod.CONFIGS) == list(jmod.CONFIGS)
    got = {}
    for side, mod in (("jax", jmod), ("port", tmod)):
        rec = _record(monkeypatch, mod)
        mod.CONFIGS[which](*args)
        got[side] = rec
    j, t = got["jax"], got["port"]
    for f in PARAM_FIELDS:
        assert getattr(t["params"], f) == getattr(j["params"], f), f
    assert t["params"].data["vo_spec"] == j["params"].data["vo_spec"]
    for f in RF_FIELDS:
        assert getattr(t["rf"], f) == getattr(j["rf"], f), f
    np.testing.assert_array_equal(np.asarray(t["rf"].X),
                                  np.asarray(j["rf"].X))
    for k in ("pools", "iterations", "ckpt_dir", "seg"):
        assert t[k] == j[k], k


@pytest.mark.parametrize("which,args", [("512", ()), ("2he", (2000,))])
def test_checkpointing_configs_take_a_ckpt_dir(runners, monkeypatch, which,
                                               args):
    """Configs 512 and 2he checkpoint to the ``ckpt_dir`` a caller gives
    (the default is the JAX runner's, checked above)."""
    _, tmod = runners
    rec = _record(monkeypatch, tmod)
    tmod.CONFIGS[which](*args, ckpt_dir="elsewhere/ckpt")
    assert rec["ckpt_dir"] == "elsewhere/ckpt"
    assert rec["seg"] == (500 if which == "512" else 1000)


def test_config5_names_the_missing_port(runners, monkeypatch):
    """Config 5 runs the port's uncertainty study
    (``examples/torch_uncertainty_study.py``) with 4096 fields per
    correlation length, as the JAX runner runs ``uncertainty_study.py
    4096``; its entry point is replaced by a recorder."""
    _, tmod = runners
    calls = []
    monkeypatch.setattr(tmod.torch_uncertainty_study, "main",
                        lambda argv, device: calls.append((argv, device)))
    tmod.CONFIGS["5"]()
    tmod.CONFIGS["5"](device="cpu")
    assert calls == [(["4096"], "cuda"), (["4096"], "cpu")]
    assert Path(tmod.torch_uncertainty_study.__file__).resolve() \
        == EXAMPLES / "torch_uncertainty_study.py"


def test_train_highres32_builds_the_jax_recipe(monkeypatch):
    """The highres32 example's parameters, with and without ``--vo``,
    equal those the JAX example hands to ``CreateTrainer``."""
    jmod = _module("train_highres32")
    tmod = _module("torch_train_highres32")
    seen = []

    class Stop(Exception):
        pass

    def create(params, dl, dlu):
        seen.append(params)
        raise Stop

    class DF:
        @staticmethod
        def FromIdentifier(identifier):
            return DF

        @staticmethod
        def setup():
            return None, None

    monkeypatch.setattr(jmod, "CreateTrainer", create)
    monkeypatch.setattr(jmod, "DataFactory", DF)
    for argv in (["x", "200"], ["x", "200", "--vo"]):
        monkeypatch.setattr("sys.argv", argv)
        with pytest.raises(Stop):
            jmod.main()
        t = tmod.build_params(200, "--vo" in argv)
        for f in PARAM_FIELDS:
            assert getattr(t, f) == getattr(seen[-1], f), (argv, f)


# ------------------------------------------------- config 2, three steps
N_S, N_VO, N_VAL, N_U, BS, N_MC = 6, 4, 4, 8, 4, 4
STAND_IN = dict(nx_rom=4, ny_rom=4, num_refines=3, dec_blocks=(1, 2),
                dtype="float64")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, dtype=np.float64)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean") or k.startswith("logsigmas"):
            v = 0.1 * rng.normal(size=v.shape)
        elif k == "logsigma":
            v = -1.0 + 0.1 * rng.normal(size=v.shape)
        out[k] = v
    return out


class _JaxRandom:
    def __init__(self, rng):
        self.rng = rng

    def normal(self, key, shape, dtype=jnp.float64):
        return jnp.asarray(self.rng.standard_normal(tuple(shape)), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float64, **kw):
        return jnp.asarray(self.rng.random(tuple(shape)), dtype)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    def __init__(self, rng):
        self.random = _JaxRandom(rng)

    def __getattr__(self, name):
        return getattr(jax, name)


def _inject(monkeypatch, seed):
    """Every sampler of both packages from one numpy stream per side, and
    the channel-dropout masks from another; returns the JAX side's
    minibatch-index function and both sides' mask shapes."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    mj, mt = (np.random.default_rng(seed + 1) for _ in range(2))
    shapes = {"j": [], "t": []}

    def jn(shape):
        return jnp.asarray(rj.standard_normal(tuple(shape)))

    def tn(shape):
        return torch.as_tensor(rt.standard_normal(tuple(shape)))

    def j_sample_all(params, key, S):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jn((m.shape[0], S, m.shape[-1]))

    def t_sample_all(params, generator, S):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * tn((m.shape[0], S, m.shape[-1]))

    def j_propagate(self, params, effprops, F, key):
        mean, logsigmas = self(params, effprops, F)
        return mean + jnp.exp(logsigmas) * jn(mean.shape)

    def j_gp(gp_out, key):
        mean, logsigmas = gp_out
        return mean + jnp.exp(logsigmas) * jn(mean.shape)

    def j_bernoulli(key, p=0.5, shape=None):
        n, _, _, c = shape
        shapes["j"].append((n, c))
        return jnp.asarray((mj.random((n, c)) < p).reshape(n, 1, 1, c))

    def t_mask(shape, keep, generator, device):
        n, c = shape[0], shape[1]
        shapes["t"].append((n, c))
        return torch.as_tensor((mt.random((n, c)) < keep).reshape(n, c, 1,
                                                                  1))

    for mod, name, fn in (
            (jva, "sample", lambda p, key: p["mean"] + jnp.exp(
                p["logsigma"]) * jn(p["logsigma"].shape)),
            (jva, "sample_all_components", j_sample_all),
            (jgen, "reparametrize", lambda key, m, ls: m + jnp.exp(ls)
             * jn(ls.shape)),
            (jgen, "propagate_gp_samples", j_gp),
            (jcomp.ReducedOrderModelOperator, "propagate_samples",
             j_propagate),
            (jvo, "jax", _Jax(rj)),
            (jax.random, "bernoulli", j_bernoulli),
            (tva, "sample", lambda p, g=None: p["mean"] + torch.exp(
                p["logsigma"]) * tn(p["logsigma"].shape)),
            (tva, "sample_all_components", t_sample_all),
            (tgen, "reparametrize", lambda g, m, ls: m + torch.exp(ls)
             * tn(ls.shape)),
            (tcomp, "reparametrize", lambda g, m, ls: m + torch.exp(ls)
             * tn(ls.shape)),
            (tcomp, "standard_normal", lambda shape, like, g=None:
             tn(shape)),
            (tvo, "sketch_normals", lambda shape, g, dtype, dev:
             tn(shape).to(dtype)),
            (tvo, "rbf_uniforms", lambda shape, g, dtype, dev:
             torch.as_tensor(rt.random(tuple(shape)), dtype=dtype)),
            (tcodec, "dropout_mask", t_mask),
            (ttrainer, "minibatch_indices", lambda g, n, k, device=None:
             torch.as_tensor(rt.permutation(n)[:k]))):
        monkeypatch.setattr(mod, name, fn)
    return (lambda n, k: jnp.asarray(rj.permutation(n)[:k])), shapes


def test_config2_stand_in_three_steps_match_jax(runners, monkeypatch):
    jmod, tmod = runners
    rec = _record(monkeypatch, tmod)
    tmod.config2()
    p = rec["params"]
    assert p.identifier == "highres" \
        and p.data["vo_spec"]["type"] == "constrain"
    p.margs.update(STAND_IN)
    p.trainer.update(N_PE_updates=0, N_monitor_interval=0,
                     N_monte_carlo_vo=N_MC, N_vo_holdoff=1,
                     N_vo_update_interval=2)
    p.data.update(N_u=N_U, N_s=N_S, N_vo=N_VO, N_u_max=N_U, N_s_max=N_S,
                  N_vo_max=N_VO, N_val=N_VAL, armortized_bs=BS)
    lr, spec = p.trainer["lr_init"], p.data["vo_spec"]

    jphys, jm, _, _, _ = jmf.highres(**STAND_IN).setup()
    assert jm.f.drop_rate == 0.2
    rng = np.random.default_rng(0)
    n_lab = N_S + N_VO + N_VAL
    rf = jfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = np.array(rf.sample(None, gamma=jnp.asarray(rng.standard_normal(
        (n_lab + N_U, rf.dim_in))), dtype=jnp.float64))
    fom = jphys["fom"]
    thetas = jfem.BoundaryConditionEnsemble.from_factory(
        "ND", n_lab, np.random.default_rng(1)).thetas
    jbce = jfem.BoundaryConditionEnsemble("ND", thetas)
    jbce.register_function_space("fom", fom.grid)
    jbce.register_function_space("rom", jphys["rom"].grid)
    X_DG = X[:n_lab].reshape(n_lab, -1)[
        :, jfem.PixelConverter(fom.grid)._cell_to_pixel]
    F = np.array(jbce.full_f_with_applied_bc("rom"))
    Y = rng.normal(0.0, 0.3, (n_lab, fom.dim_out))
    params, bs = jm.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(X[:N_S])},
         "unsupervised": {"X": jnp.asarray(X[n_lab:])},
         "vo": {"X": jnp.asarray(X[N_S:N_S + N_VO])}}, (32, 32))
    prng = np.random.default_rng(2)
    params, bs = _perturb(_np(params), prng), _perturb(_np(bs), prng)

    tphys = tfem.make_fom_rom_pair("ND", 4, 4, 3, device="cpu")
    tbce = tfem.BoundaryConditionEnsemble("ND", thetas)
    tbce.register_function_space("fom", tphys["fom"].grid)
    tbce.register_function_space("rom", tphys["rom"].grid)
    dl = DataLoader(X[:n_lab], X_DG=X_DG, Y=Y, BCE=tbce, F_ROM_BC=F)
    dlu = DataLoader(X[n_lab:])
    dlu.lock_physics_assembly()
    trainer = CreateTrainer(p, dl, dlu, device="cpu")
    assert trainer.use_vo() and trainer.model.encoder is not None
    load_flax_variables(trainer.model, params, bs)

    class FakeDS:
        def get(self, key):
            return {"X_DG": jnp.asarray(X_DG[N_S:N_S + N_VO]),
                    "BCE": jbce[list(range(N_S, N_S + N_VO))]}[key]

    jvo_ens = jvo.build_virtual_observables_ensemble(spec, FakeDS(), jphys,
                                                     dtype=jnp.float64)
    assert jvo_ens.m == trainer.VO.m
    jidx, mask_shapes = _inject(monkeypatch, 29)
    jvo_ens._sample_jit = lambda key: jvo_ens.sampler.sample(jvo_ens.qpe,
                                                             key)
    opt = optax.adam(jsch.make_schedule(p.scheduler, lr))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": jnp.asarray(X[:N_S]), "Y": jnp.asarray(Y[:N_S]),
           "F_ROM_BC": jnp.asarray(F[:N_S])}
    data_vo = {"X": jnp.asarray(X[N_S:N_S + N_VO]),
               "F_ROM_BC": jnp.asarray(F[N_S:N_S + N_VO])}
    X_u = jnp.asarray(X[n_lab:])
    elbos_j, vo_state = [], (jnp.zeros((1, 1)),) * 2
    for gn in range(3):
        if gn >= 1:  # the refresh comes first (holdoff 1, interval 2)
            Y_mean, Y_std = jm.propagate_vo_moments(
                jp, data_vo, jax.random.PRNGKey(0), N_MC)
            jvo_ens.resample(jax.random.PRNGKey(0))
            jvo_ens.update(Y_mean, 1.0 / Y_std ** 2, gn)
            vo_state = (jvo_ens.mean, jvo_ens.logsigma)
        d = {"supervised": sup, "unsupervised": {"X": X_u[jidx(N_U, BS)]},
             "vo": data_vo}

        def loss(q):
            e, new_bs, _ = jm.elbo(q, jbs, d, jax.random.PRNGKey(0),
                                   vo_state=vo_state, vo_holdoff=gn < 1)
            return -e, new_bs

        (neg, jbs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        updates, opt_state = opt.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        elbos_j.append(float(-neg))

    for _ in range(3):
        trainer.step()
    assert mask_shapes["t"] == mask_shapes["j"] and mask_shapes["t"]
    assert _rel(trainer.elbos().numpy(), elbos_j) <= 1e-7
    for name in ("mean", "vars", "vo_variances"):
        assert _rel(getattr(trainer.VO, name), getattr(jvo_ens, name)) \
            <= 1e-7, name
    ref = copy.deepcopy(trainer.model)
    load_flax_variables(ref, _np(jp), _np(jbs))
    want = dict(ref.named_parameters())
    for name, prm in trainer.model.named_parameters():
        assert _rel(prm.detach().numpy(), want[name].detach().numpy()) \
            <= 1e-7, name
    want = dict(ref.named_buffers())
    for name, b in trainer.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert _rel(b.numpy(), want[name].numpy()) <= 1e-7, name
