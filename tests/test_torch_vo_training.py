"""The port's virtual-observable training against the JAX package: the VO
term of the ELBO with and without the holdoff and its gradients, the
Monte-Carlo moment propagation, the trainer's partition with a 'vo' chunk,
the refresh cadence, and three SVI steps across a VO refresh.

Shared inputs as in ``tests/test_torch_training.py``: both packages start
from the JAX model's Flax state (carried across by ``convert.py``, the
'vo' posteriors included), and every random draw is injected from one
numpy stream per side in call order -- the posterior and reparametrised
draws, the minibatch indices, the propagation draws
(``sample_all_components``, the ROM push-through, the property map) and
the test functions (the port's ``sketch_normals`` / ``rbf_uniforms``, the
JAX module's ``jax.random.normal`` / ``uniform``).  A replaced JAX sampler
runs when it is traced, so each JAX ELBO evaluation is traced afresh, the
moment propagation runs eagerly and the JAX ensemble samples eagerly.

Tolerances (f64): the VO ELBO and its gradients 1e-8; propagated moments
1e-10; three SVI steps across a refresh (ELBOs, parameters, VO moments)
1e-7, as the port's three-step test without VO.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.constraints import (
    virtual_observables as jvo)
from generative_physics_informed_pde_tpu.data import DataLoader as JDataLoader
from generative_physics_informed_pde_tpu.factories.model import (
    highres32 as j_highres32)
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import components as jcomp
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu.training import trainer as jtrainer
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.constraints import (
    virtual_observables as tvo)
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import components as tcomp
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

N_S, N_VO, N_VAL, N_U, BS, N_MC = 8, 6, 6, 12, 6, 4
SPEC = {"type": "constrain", "CGR": True, "flux": True, "N_gaussian": 2,
        "N_rbf": 2, "l_rbf": 0.2}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


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
    """Replace every sampler of both packages with one numpy stream per
    side; returns the JAX side's minibatch-index function."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)

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

    monkeypatch.setattr(jva, "sample", lambda p, key: p["mean"] + jnp.exp(
        p["logsigma"]) * jn(p["logsigma"].shape))
    monkeypatch.setattr(jva, "sample_all_components", j_sample_all)
    monkeypatch.setattr(jgen, "reparametrize", lambda key, m, ls: m + jnp.exp(
        ls) * jn(ls.shape))
    monkeypatch.setattr(jgen, "propagate_gp_samples", j_gp)
    monkeypatch.setattr(jcomp.ReducedOrderModelOperator, "propagate_samples",
                        j_propagate)
    monkeypatch.setattr(jvo, "jax", _Jax(rj))
    monkeypatch.setattr(tva, "sample", lambda p, g=None: p["mean"] + torch.exp(
        p["logsigma"]) * tn(p["logsigma"].shape))
    monkeypatch.setattr(tva, "sample_all_components", t_sample_all)
    monkeypatch.setattr(tgen, "reparametrize", lambda g, m, ls: m + torch.exp(
        ls) * tn(ls.shape))
    monkeypatch.setattr(tcomp, "reparametrize", lambda g, m, ls: m + torch.exp(
        ls) * tn(ls.shape))
    monkeypatch.setattr(tcomp, "standard_normal", lambda shape, like, g=None:
                        tn(shape))
    monkeypatch.setattr(tvo, "sketch_normals", lambda shape, g, dtype, dev:
                        tn(shape).to(dtype))
    monkeypatch.setattr(tvo, "rbf_uniforms", lambda shape, g, dtype, dev:
                        torch.as_tensor(rt.random(tuple(shape)), dtype=dtype))
    monkeypatch.setattr(ttrainer, "minibatch_indices",
                        lambda g, n, k, device=None: torch.as_tensor(
                            rt.permutation(n)[:k]))
    return lambda n, k: jnp.asarray(rj.permutation(n)[:k])


def _perturb(tree, rng, scale=0.1):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, scale)
            continue
        v = np.asarray(v, dtype=np.float64)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean", "logsigma") or k.startswith("logsigmas"):
            v = scale * rng.normal(size=v.shape)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def setting():
    """Fields, boundary conditions, labels and the shared f64 state."""
    rf = jfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    rng = np.random.default_rng(0)
    n_lab = N_S + N_VO + N_VAL
    gamma = rng.standard_normal((n_lab + N_U, rf.dim_in))
    X = np.array(rf.sample(None, gamma=jnp.asarray(gamma), dtype=jnp.float64))
    physics, jmodel, _, _, _ = j_highres32(dtype="float64").setup()
    fom = physics["fom"]
    thetas = jfem.BoundaryConditionEnsemble.from_factory(
        "NDP", n_lab, np.random.default_rng(1)).thetas
    bce = jfem.BoundaryConditionEnsemble("NDP", thetas)
    bce.register_function_space("fom", fom.grid)
    bce.register_function_space("rom", physics["rom"].grid)
    X_DG = X[:n_lab].reshape(n_lab, -1)[
        :, jfem.PixelConverter(fom.grid)._cell_to_pixel]
    data = {"X": X[:n_lab], "X_u": X[n_lab:], "X_DG": X_DG,
            "F": np.array(bce.full_f_with_applied_bc("rom")),
            "Y": rng.normal(0.0, 0.3, (n_lab, fom.dim_out)),
            "thetas": thetas}
    params, bs = jmodel.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(X[:N_S])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])},
         "vo": {"X": jnp.asarray(X[N_S:N_S + N_VO])}}, (32, 32))
    prng = np.random.default_rng(2)
    params = _perturb(_to_np(params), prng)
    for group in ("q_z", "q_X"):
        for q in params[group].values():
            q["logsigma"] = -1.0 + 0.1 * prng.normal(size=q["logsigma"].shape)
    bs = _perturb(_to_np(bs), prng)
    return physics, jmodel, params, bs, data, bce


def _vo_data(data, lib):
    sl = slice(N_S, N_S + N_VO)
    return {"X": lib(data["X"][sl]), "F_ROM_BC": lib(data["F"][sl])}


def _port_model(params, bs):
    _, model, _, _, _ = highres32(dtype="float64").setup(device="cpu")
    model.init_params({k: {"X": np.zeros((n, 1))} for k, n in (
        ("supervised", N_S), ("unsupervised", N_U), ("vo", N_VO))})
    return load_flax_variables(model, params, bs)


def _stats(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


# --------------------------------------------------------------- ELBO term
@pytest.mark.parametrize("holdoff", [False, True])
def test_vo_elbo_and_gradients_match_jax(setting, monkeypatch, holdoff):
    physics, jmodel, params, bs, data, _ = setting
    model = _port_model(params, bs)
    _inject(monkeypatch, 17)
    rng = np.random.default_rng(3)
    vo_mean = rng.normal(0, 0.3, (N_VO, model.dim_y))
    vo_logsigma = -2.0 + 0.1 * rng.normal(size=vo_mean.shape)

    def loss(p):
        e, new_bs, logs = jmodel.elbo(
            p, bs, {"vo": _vo_data(data, jnp.asarray)},
            jax.random.PRNGKey(0), vo_holdoff=holdoff,
            vo_state=(jnp.asarray(vo_mean), jnp.asarray(vo_logsigma)))
        return e, (new_bs, logs)

    (ej, (bs_j, logs_j)), gj = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    et, logs_t = model.elbo(
        {"vo": _vo_data(data, torch.as_tensor)}, None, vo_holdoff=holdoff,
        vo_state=(torch.as_tensor(vo_mean), torch.as_tensor(vo_logsigma)))
    et.backward()
    assert _rel(et.detach().numpy(), ej) <= 1e-8
    for k in ("vo_logL_x", "vo_logL_y", "vo_logL_X", "vo_entropy_X",
              "vo_DKL", "vo_elbo"):
        assert _rel(torch.as_tensor(logs_t[k]).detach().numpy(),
                    logs_j[k]) <= 1e-8, k
    if holdoff:
        assert logs_t["vo_logL_y"] == 0.0
    want = copy.deepcopy(model)
    load_flax_variables(want, _to_np(gj), bs)
    want = dict(want.named_parameters())
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].detach().numpy(),
                                   rtol=0, atol=1e-8 * max(
                                       1.0, float(want[name].detach().abs().max())),
                                   err_msg=name)
    ref = copy.deepcopy(model)
    load_flax_variables(ref, params, _to_np(bs_j))
    for name, b in _stats(model).items():
        assert _rel(b.numpy(), _stats(ref)[name].numpy()) <= 1e-8, name
    model.disable_elbo_vo = True
    assert model.elbo_virtual_observables(
        {}, None, vo_mean=None, vo_logsigma=None) == (0.0, {})


@pytest.mark.parametrize("independent_X", [True, False])
def test_propagate_vo_moments_match_jax(setting, monkeypatch, independent_X):
    physics, jmodel, params, bs, data, _ = setting
    model = _port_model(params, bs)
    model.independent_X = independent_X
    jm = jmodel if independent_X else \
        jgen.dataclasses.replace(jmodel, independent_X=False)
    _inject(monkeypatch, 19)
    mj, sj = jm.propagate_vo_moments(params, _vo_data(data, jnp.asarray),
                                     jax.random.PRNGKey(0), N_MC)
    with torch.no_grad():
        mt, st = model.propagate_vo_moments(_vo_data(data, torch.as_tensor),
                                            None, N_MC)
    assert mt.shape == st.shape == (N_VO, model.dim_y)
    assert _rel(mt, mj) <= 1e-10 and _rel(st, sj) <= 1e-10
    with pytest.raises(ValueError, match=">= 2"):
        model.propagate_vo_moments(_vo_data(data, torch.as_tensor), None, 1)


# ----------------------------------------------------------------- trainer
def _loaders(data, port=True):
    n_lab = N_S + N_VO + N_VAL
    if port:
        bce = tfem.BoundaryConditionEnsemble("NDP", data["thetas"])
        loader = DataLoader
    else:
        bce = jfem.BoundaryConditionEnsemble("NDP", data["thetas"])
        loader = JDataLoader
    phys = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    bce.register_function_space("fom", phys["fom"].grid)
    bce.register_function_space("rom", phys["rom"].grid)
    dl = loader(data["X"], X_DG=data["X_DG"], Y=data["Y"], BCE=bce,
                F_ROM_BC=data["F"])
    dlu = loader(data["X_u"])
    assert dl.N == n_lab
    return dl, dlu


def _params(lr=1e-2, **trainer):
    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs["dtype"] = "float64"
    p.trainer.update(lr_init=lr, N_PE_updates=0, N_monitor_interval=0,
                     N_monte_carlo_vo=N_MC, **trainer)
    p.data.update(N_u=N_U, N_s=N_S, N_vo=N_VO, N_u_max=N_U, N_s_max=N_S,
                  N_vo_max=N_VO, N_val=N_VAL, armortized_bs=BS,
                  vo_spec=dict(SPEC))
    return p


def test_partition_with_vo_chunk_matches_jax(setting):
    """supervised, vo, validation: the same permutation gives the same
    chunks in both packages; N_vo = 0 drops the chunk, N_vo > 0 needs
    it."""
    *_, data, _ = setting
    perm = np.random.default_rng(5).permutation(N_S + N_VO + N_VAL)
    perm_u = np.random.default_rng(6).permutation(N_U)
    out = {}
    for port in (True, False):
        dl, dlu = _loaders(data, port)
        create = (ttrainer if port else jtrainer).CreateDataSetsFromPermutation
        kw = {"device": "cpu"} if port else {}
        _, _, ds = create("highres32", perm, perm_u, N_VAL, N_U, N_S, N_VO,
                          None, None, torch.float64 if port else jnp.float64,
                          dl=dl, dlu=dlu, **kw)
        out[port] = ds
    assert list(out[True]) == list(out[False]) == [
        "supervised", "vo", "validation", "unsupervised"]
    for name, chunk in out[True].items():
        np.testing.assert_array_equal(chunk.indices, out[False][name].indices)
    np.testing.assert_array_equal(out[True]["vo"].indices,
                                  perm[N_S:N_S + N_VO])
    np.testing.assert_array_equal(out[True]["vo"].get("X_DG").numpy(),
                                  out[False]["vo"].get("X_DG"))

    dl, dlu = _loaders(data)
    p = _params()
    p.data["N_vo"] = 0
    tr = CreateTrainer(p, dl, dlu, device="cpu")
    assert not tr.use_vo() and "vo" not in tr.datasets
    assert "vo" not in tr.model.q_z
    p = _params()
    p.data["N_vo_max"] = 0
    with pytest.raises(ValueError, match="vo chunk"):
        CreateTrainer(p, *_loaders(data), device="cpu")


class _JaxGate:
    """The state the JAX trainer's ``update_vo`` reads."""

    def __init__(self, holdoff, interval):
        self.gn, self._vo_is_initialized = 0, False
        self.cfg = {"N_vo_holdoff": holdoff,
                    "N_vo_update_interval": interval}

    def use_vo(self):
        return True

    def get(self, key):
        return self.cfg[key]


def test_refresh_cadence_matches_jax(setting):
    """update_vo step for step over 12 steps (holdoff 3, interval 5); the
    refreshes happen there and the VO term is held off before the
    first."""
    *_, data, _ = setting
    tr = CreateTrainer(_params(N_vo_holdoff=3, N_vo_update_interval=5),
                       *_loaders(data), device="cpu")
    gate = _JaxGate(3, 5)
    refreshes = []
    orig = tr.update_virtual_observables
    tr.update_virtual_observables = lambda step: (refreshes.append(step),
                                                  orig(step))
    want, held = [], []
    for _ in range(12):
        due = jtrainer.Trainer.update_vo(gate)
        assert tr.update_vo() == due
        want += [gate.gn] if due else []
        gate._vo_is_initialized |= due
        logs = tr.step()
        held.append(float(logs["vo_logL_y"]) == 0.0)
        gate.gn += 1
    assert refreshes == want == [3, 5, 10]
    assert held == [True] * 3 + [False] * 9
    assert tr.gn == 12
    assert tr._vo_state[0].shape == (N_VO, tr.physics["fom"].dim_out)
    assert tr.writer.scalars["Monitor/Mean_VO_variances"][-1][0] == 10
    assert bool(torch.isfinite(tr.elbos()).all())


def test_three_svi_steps_across_a_refresh_match_jax(setting, monkeypatch):
    """Holdoff 1, interval 2: step 0 holds the VO term off, steps 1 and 2
    each refresh first (propagate, resample, condition), then step.  No
    unlabeled term (``tests/test_torch_training.py`` covers it), which
    keeps the three JAX traces short."""
    physics, jmodel, params, bs, data, bce = setting
    lr = 1e-2
    p = _params(lr, N_vo_holdoff=1, N_vo_update_interval=2)
    p.data.update(N_u=0, N_u_max=0, armortized_bs=None)
    trainer = CreateTrainer(p, *_loaders(data), device="cpu")

    def no_unsup(tree):  # the port has no unlabeled posterior here
        return {**tree, "q_z": {k: v for k, v in tree["q_z"].items()
                                if k != "unsupervised"}}

    load_flax_variables(trainer.model, no_unsup(params), bs)

    class FakeDS:
        def get(self, key):
            sl = slice(N_S, N_S + N_VO)
            return {"X_DG": jnp.asarray(data["X_DG"][sl]),
                    "BCE": bce[list(range(N_S, N_S + N_VO))]}[key]

    jvo_ens = jvo.build_virtual_observables_ensemble(SPEC, FakeDS(), physics,
                                                     dtype=jnp.float64)
    _inject(monkeypatch, 23)
    jvo_ens._sample_jit = lambda key: jvo_ens.sampler.sample(jvo_ens.qpe,
                                                             key)
    opt = optax.adam(jsch.make_schedule(None, lr))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": jnp.asarray(data["X"][:N_S]),
           "Y": jnp.asarray(data["Y"][:N_S]),
           "F_ROM_BC": jnp.asarray(data["F"][:N_S])}
    data_vo = _vo_data(data, jnp.asarray)
    elbos_j, vo_state = [], (jnp.zeros((1, 1)),) * 2
    for gn in range(3):
        if gn >= 1:  # the refresh comes first (holdoff 1, interval 2)
            Y_mean, Y_std = jmodel.propagate_vo_moments(
                jp, data_vo, jax.random.PRNGKey(0), N_MC)
            jvo_ens.resample(jax.random.PRNGKey(0))
            jvo_ens.update(Y_mean, 1.0 / Y_std ** 2, gn)
            vo_state = (jvo_ens.mean, jvo_ens.logsigma)
        d = {"supervised": sup, "vo": data_vo}

        def loss(p):
            e, new_bs, _ = jmodel.elbo(p, jbs, d, jax.random.PRNGKey(0),
                                       vo_state=vo_state,
                                       vo_holdoff=gn < 1)
            return -e, new_bs

        (neg, jbs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        updates, opt_state = opt.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        elbos_j.append(float(-neg))

    for _ in range(3):
        trainer.step()
    np.testing.assert_allclose(trainer.elbos().numpy(), elbos_j, rtol=1e-7)
    assert trainer._vo_is_initialized
    assert _rel(trainer.VO.mean, jvo_ens.mean) <= 1e-7
    assert _rel(trainer.VO.vars, jvo_ens.vars) <= 1e-7
    assert _rel(trainer.VO.vo_variances, jvo_ens.vo_variances) <= 1e-7
    want = copy.deepcopy(trainer.model)
    load_flax_variables(want, no_unsup(_to_np(jp)), bs)
    want = dict(want.named_parameters())
    for name, p in trainer.model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].detach().numpy()) <= 1e-7,\
            name
    ref = copy.deepcopy(trainer.model)
    load_flax_variables(ref, no_unsup(params), _to_np(jbs))
    for name, b in _stats(trainer.model).items():
        assert _rel(b.numpy(), _stats(ref)[name].numpy()) <= 1e-7, name
