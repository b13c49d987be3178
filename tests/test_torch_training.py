"""The port's training slice against the JAX package: decoder (train and
eval mode, BatchNorm statistics), likelihoods and variational helpers,
the composite ELBO and its gradients, three SVI steps (ELBO + Adam +
``multistep_lr``), one prediction-ensemble step, the analysis metrics, the
schedules and the data loader; plus a port-only trainer smoke run.

Shared inputs: both packages start from the JAX model's Flax state,
carried across by ``convert.py``, and the random draws are injected: on
each side ``va.sample`` / ``reparametrize`` / ``minibatch_indices`` are
replaced by functions that hand out the same numpy normals and indices in
call order.  A replaced sampler runs when the JAX side is traced, so each
JAX evaluation (one ELBO, one SVI step) is traced afresh with
``jax.jit(jax.value_and_grad(...))`` and never reused; the prediction
ensemble's ``fori_loop`` body is run that way one step at a time.

Tolerances (f64): decoder and its statistics 1e-8 (convolution sums in
another order); likelihoods 1e-12; ELBO and gradients 1e-8; the
three-step trajectory and parameters 1e-7 (torch's Adam divides by
``sqrt(v)/sqrt(bc2) + eps``, optax by ``sqrt(v/bc2) + eps``: equal in
exact arithmetic, rounded differently); prediction ensemble 1e-8;
metrics on fixed predictions 1e-10.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.data import DataLoader as JDataLoader
from generative_physics_informed_pde_tpu.factories.model import (
    highres32 as j_highres32)
from generative_physics_informed_pde_tpu.inference import likelihoods as jlk
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.inference.prediction import (
    PredictionEnsemble as JPredictionEnsemble)
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.inference import analysis
from generative_physics_informed_pde_tpu_torch.inference import (
    likelihoods as tlk)
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.inference.prediction import (
    PredictionEnsemble)
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    TrainerParameters, CreateTrainer, make_schedule, multistep_lr)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

N_S, N_U, N_VAL, BS = 12, 16, 8, 8


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Draws:
    """Standard normals and minibatch indices in call order, from one
    numpy seed: two instances with the same seed serve both packages."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape))

    def indices(self, n, k):
        return self.rng.permutation(n)[:k]


def _inject(monkeypatch, seed):
    """Replace the samplers of both packages with same-order draws."""
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

    def t_minibatch(generator, num_data, batch_size, device=None):
        return torch.as_tensor(dt.indices(num_data, batch_size))

    monkeypatch.setattr(jva, "sample", j_sample)
    monkeypatch.setattr(jgen, "reparametrize", j_reparametrize)
    monkeypatch.setattr(tva, "sample", t_sample)
    monkeypatch.setattr(tgen, "reparametrize", t_reparametrize)
    monkeypatch.setattr(ttrainer, "minibatch_indices", t_minibatch)
    return lambda n, k: jnp.asarray(dj.indices(n, k))


def _perturb(tree, rng, scale=0.1):
    """Random BatchNorm scales/statistics, posteriors and logsigmas, f64
    (a fresh init holds ones and zeros)."""
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


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def setting():
    """Fields, labels, forces and the shared f64 initial state."""
    rf = jfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    rng = np.random.default_rng(0)
    gamma = rng.standard_normal((N_S + N_VAL + N_U, rf.dim_in))
    X = np.array(rf.sample(None, gamma=jnp.asarray(gamma),
                           dtype=jnp.float64))  # a writable copy
    physics, jmodel, _, _, _ = j_highres32(dtype="float64").setup()
    bce = jfem.BoundaryConditionEnsemble.from_factory(
        "NDP", N_S + N_VAL, np.random.default_rng(1))
    bce.register_function_space("fom", physics["fom"].grid)
    bce.register_function_space("rom", physics["rom"].grid)
    F = np.array(bce.full_f_with_applied_bc("rom"))
    Y = rng.normal(0.0, 0.3, (N_S + N_VAL, physics["fom"].dim_out))
    data = {"X_s": X[:N_S], "Y_s": Y[:N_S], "F_s": F[:N_S],
            "X_val": X[N_S:N_S + N_VAL], "Y_val": Y[N_S:N_S + N_VAL],
            "F_val": F[N_S:N_S + N_VAL], "X_u": X[N_S + N_VAL:]}
    params, bs = jmodel.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(data["X_s"])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])}}, (32, 32))
    prng = np.random.default_rng(2)
    params = _perturb(_to_np(params), prng)
    # keep the posteriors' spread moderate
    for q in (params["q_z"]["supervised"], params["q_X"]["supervised"]):
        q["logsigma"] = -1.0 + 0.1 * prng.normal(size=q["logsigma"].shape)
    bs = _perturb(_to_np(bs), prng)
    return jmodel, params, bs, data


def _port_model(params, bs, data):
    _, model, _, _, dtype = highres32(dtype="float64").setup(device="cpu")
    assert dtype == torch.float64
    model.init_params({"supervised": {"X": data["X_s"]},
                       "unsupervised": {"X": data["X_u"]}})
    return load_flax_variables(model, params, bs)


def _grads_as_port(model, jgrads, bs):
    """The JAX gradient tree mapped onto the port's parameter names."""
    g = copy.deepcopy(model)
    load_flax_variables(g, jgrads, bs)
    return dict(g.named_parameters())


def _stats_as_port(model, params, jbs):
    g = copy.deepcopy(model)
    load_flax_variables(g, params, jbs)
    return {n: b for n, b in g.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _port_stats(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


# ------------------------------------------------------------------ decoder
@pytest.mark.parametrize("train", [False, True])
def test_decoder_matches_flax(setting, train):
    jmodel, params, bs, _ = setting
    model = _port_model(params, bs, setting[3])
    z = np.random.default_rng(4).normal(size=(6, 16))
    variables = {"params": params["f"], "batch_stats": bs["f"]}
    if train:
        (mj, lj), mut = jmodel.f.apply(variables, jnp.asarray(z), train=True,
                                       mutable=["batch_stats"])
    else:
        mj, lj = jmodel.f.apply(variables, jnp.asarray(z), train=False)
    mt, lt = model.apply_decoder(torch.as_tensor(z), train=train)
    assert mt.shape == (6, 32, 32) and lt.shape == (6, 32, 32)
    assert _rel(mt.detach().numpy(), mj) <= 1e-8
    assert _rel(lt.detach().numpy(), lj) <= 1e-8
    want = _stats_as_port(model.f, params["f"],
                          mut["batch_stats"] if train else bs["f"])
    got = _port_stats(model.f)
    assert set(got) == set(want) and len(got) == 14
    for name in got:
        assert _rel(got[name].numpy(), want[name].numpy()) <= 1e-8, name


def test_decoder_layout_and_upsampling():
    from generative_physics_informed_pde_tpu.models.codec import (
        upsample_nearest_2x as j_up)
    from generative_physics_informed_pde_tpu_torch.models import (
        CNNDecoder, channel_dropout, upsample_nearest_2x)
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5))  # NCHW
    ref = np.asarray(j_up(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = upsample_nearest_2x(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), ref)
    with pytest.raises(ValueError, match="target"):
        CNNDecoder(30, 16, latent_img_size=8, blocks=(1, 1))
    single = CNNDecoder(32, 16, latent_img_size=8, latent_img_features=1,
                        init_features=4, blocks=(1, 1), growth_rate=4,
                        force_single_output=True)
    assert single(torch.zeros(2, 16)).shape == (2, 32, 32)
    t = torch.ones(2, 3, 4, 4)
    assert torch.equal(channel_dropout(t, 0.0, True), t)
    assert torch.equal(channel_dropout(t, 0.5, False), t)


# -------------------------------------------------------------- likelihoods
def test_likelihoods_and_variational_helpers_match_jax():
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(size=(5, 9)) for _ in range(3))
    std = np.exp(0.3 * c)
    pairs = [
        (tlk.diagonal_gaussian_log_likelihood, jlk.diagonal_gaussian_log_likelihood,
         (a, b, c)),
        (tlk.unit_gaussian_kld, jlk.unit_gaussian_kld, (a, c)),
        (tlk.relative_error_batched, jlk.relative_error_batched, (a, b)),
        (tlk.coefficient_of_determination,
         jlk.coefficient_of_determination, (a, b)),
    ]
    for t_fn, j_fn, args in pairs:
        got = t_fn(*(torch.as_tensor(x) for x in args)).numpy()
        ref = np.asarray(j_fn(*(jnp.asarray(x) for x in args)))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    got = tlk.coefficient_of_determination(torch.as_tensor(a),
                                           torch.as_tensor(b), True)
    ref = jlk.coefficient_of_determination(jnp.asarray(a), jnp.asarray(b),
                                           True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    p = 1 / (1 + np.exp(-a))
    np.testing.assert_allclose(
        tlk.bernoulli_log_likelihood(torch.as_tensor(p),
                                     torch.as_tensor(b)).numpy(),
        jlk.bernoulli_log_likelihood(jnp.asarray(p), jnp.asarray(b)),
        rtol=1e-12)
    # the row functions are the JAX ones vmapped over rows
    np.testing.assert_allclose(
        tlk.relative_error(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        jax.vmap(jlk.relative_error)(jnp.asarray(a), jnp.asarray(b)),
        rtol=1e-12)
    np.testing.assert_allclose(
        tlk.predictive_logscore(torch.as_tensor(b), torch.as_tensor(a),
                                torch.as_tensor(std)).numpy(),
        jax.vmap(jlk.predictive_logscore)(jnp.asarray(b), jnp.asarray(a),
                                          jnp.asarray(std)), rtol=1e-12)
    q = {"mean": a, "logsigma": 0.2 * c}
    tq = {k: torch.as_tensor(v) for k, v in q.items()}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    np.testing.assert_allclose(tva.kld(tq).numpy(), jva.kld(jq), rtol=1e-12)
    np.testing.assert_allclose(tva.entropy(tq).numpy(), jva.entropy(jq),
                               rtol=1e-12)
    init = tva.init_variational(4, 3, dtype=torch.float64,
                                init_logsigma=-1.0)
    ref = jva.init_variational(4, 3, dtype=jnp.float64, init_logsigma=-1.0)
    for k in ("mean", "logsigma"):
        np.testing.assert_array_equal(init[k].detach().numpy(), ref[k])
    g = torch.Generator().manual_seed(0)
    assert tva.sample(tq, g).shape == (5, 9)
    assert tva.sample_all_components(tq, g, 3).shape == (5, 3, 9)
    assert tva.sample_component(tq, 2, g, 4).shape == (4, 9)


# --------------------------------------------------------------------- ELBO
def test_elbo_and_gradients_match_jax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    model = _port_model(params, bs, data)
    idx = _inject(monkeypatch, 11)
    jdata = {"supervised": {"X": jnp.asarray(data["X_s"]),
                            "Y": jnp.asarray(data["Y_s"]),
                            "F_ROM_BC": jnp.asarray(data["F_s"])},
             "unsupervised": {"X": jnp.asarray(data["X_u"][:BS])}}
    tdata = {"supervised": {"X": torch.as_tensor(data["X_s"]),
                            "Y": torch.as_tensor(data["Y_s"]),
                            "F_ROM_BC": torch.as_tensor(data["F_s"])},
             "unsupervised": {"X": torch.as_tensor(data["X_u"][:BS])}}
    del idx

    def loss(p):
        e, new_bs, logs = jmodel.elbo(p, bs, jdata, jax.random.PRNGKey(0),
                                      l2_penalty=1e-3)
        return e, (new_bs, logs)

    # one evaluation: under jit each replaced sampler runs once, at trace
    # time, in call order -- the same draws as eagerly, compiled once
    (ej, (bs_j, logs_j)), gj = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    et, logs_t = model.elbo(tdata, None, l2_penalty=1e-3)
    et.backward()
    assert _rel(et.detach().numpy(), ej) <= 1e-8
    for k in ("supervised_logL_x", "supervised_logL_y", "supervised_logL_X",
              "ARM_unsupervised_logL_x", "ARM_unsupervised_DKL_z",
              "elbo_l2_penalty"):
        assert _rel(logs_t[k].detach().numpy(), logs_j[k]) <= 1e-8, k
    want = _grads_as_port(model, _to_np(gj), bs)
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want[name].detach().numpy()) <= 1e-8, \
            name
    # BatchNorm statistics: unsupervised decode first, then supervised
    want = _stats_as_port(model, params, _to_np(bs_j))
    for name, b in _port_stats(model).items():
        assert _rel(b.numpy(), want[name].numpy()) <= 1e-8, name


# ------------------------------------------------------- three SVI steps
def _port_trainer(data, params, bs, lr, milestones, factor):
    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs["dtype"] = "float64"
    p.trainer.update(lr_init=lr, N_PE_updates=0, N_monitor_interval=0)
    p.scheduler = {"milestones": milestones, "factor": factor}
    p.data.update(N_u=N_U, N_s=N_S, N_u_max=N_U, N_s_max=N_S, N_val=N_VAL,
                  armortized_bs=BS)
    X = np.concatenate([data["X_s"], data["X_val"]])
    Y = np.concatenate([data["Y_s"], data["Y_val"]])
    F = np.concatenate([data["F_s"], data["F_val"]])
    dl = DataLoader(X, Y=Y, F_ROM_BC=F)
    dlu = DataLoader(data["X_u"])
    trainer = CreateTrainer(p, dl, dlu, device="cpu")
    load_flax_variables(trainer.model, params, bs)
    return trainer


def test_three_svi_steps_match_jax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    lr, milestones, factor = 1e-2, [1, 2], 0.5
    trainer = _port_trainer(data, params, bs, lr, milestones, factor)
    jidx = _inject(monkeypatch, 23)

    opt = optax.adam(jsch.make_schedule(
        {"milestones": milestones, "factor": factor}, lr))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": jnp.asarray(data["X_s"]), "Y": jnp.asarray(data["Y_s"]),
           "F_ROM_BC": jnp.asarray(data["F_s"])}
    X_u = jnp.asarray(data["X_u"])
    elbos_j = []
    for _ in range(3):
        # the order of step_body: minibatch, then the ELBO's draws
        d = {"supervised": sup, "unsupervised": {"X": X_u[jidx(N_U, BS)]}}

        def loss(p):
            e, new_bs, _ = jmodel.elbo(p, jbs, d, jax.random.PRNGKey(0))
            return -e, new_bs

        # a fresh trace per step: the replaced samplers draw anew
        (neg, jbs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        updates, opt_state = opt.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        elbos_j.append(float(-neg))

    for _ in range(3):
        trainer.step()
    elbos_t = trainer.elbos().numpy()
    np.testing.assert_allclose(elbos_t, elbos_j, rtol=1e-7)
    want = _grads_as_port(trainer.model, _to_np(jp), bs)
    for name, p in trainer.model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].detach().numpy()) <= 1e-7,\
            name
    want = _stats_as_port(trainer.model, params, _to_np(jbs))
    for name, b in _port_stats(trainer.model).items():
        assert _rel(b.numpy(), want[name].numpy()) <= 1e-7, name


# ----------------------------------------------------- prediction ensemble
def test_prediction_ensemble_step_matches_jax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    model = _port_model(params, bs, data)
    _inject(monkeypatch, 31)
    X_val = data["X_val"]
    sched = jsch.make_schedule({"milestones": [1], "factor": 0.5}, 1e-2)
    jpe = JPredictionEnsemble(model=jmodel, X=jnp.asarray(X_val),
                              optimizer=optax.adam(sched))
    q, opt_state = jpe.init(dtype=jnp.float64)
    q0 = q = {k: v + 0.1 for k, v in q.items()}  # a start away from zero
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jbs = jax.tree_util.tree_map(jnp.asarray, bs)

    def loss(qp):
        elbo, logL = jpe.elbo(jp, jbs, qp, jax.random.PRNGKey(0))
        return -elbo, logL

    for _ in range(2):  # the body of PredictionEnsemble.update
        (neg, logL_j), g = jax.jit(jax.value_and_grad(loss,
                                                      has_aux=True))(q)
        updates, opt_state = jpe.optimizer.update(g, opt_state, q)
        q = optax.apply_updates(q, updates)

    pe = PredictionEnsemble(model, torch.as_tensor(X_val),
                            make_schedule({"milestones": [1],
                                           "factor": 0.5}, 1e-2))
    load_flax_variables(pe.q, _to_np(q0))  # the PE's q carries across too
    stats = {n: b.clone() for n, b in _port_stats(model).items()}
    for _ in range(2):
        elbo_t, logL_t = pe.update(1)
    assert _rel(elbo_t.numpy(), -neg) <= 1e-8
    assert _rel(logL_t.numpy(), logL_j) <= 1e-8
    for k in ("mean", "logsigma"):
        assert _rel(pe.q[k].detach().numpy(), q[k]) <= 1e-8, k
    # only q moved: the decoder's statistics and gradients are untouched
    for n, b in _port_stats(model).items():
        assert torch.equal(b, stats[n]), n
    assert all(p.grad is None for p in model.parameters())


# ----------------------------------------------------------------- metrics
def test_analysis_metrics_on_fixed_predictions_match_jax():
    rng = np.random.default_rng(9)
    Y = rng.normal(size=(6, 11))
    y_mean = Y + 0.2 * rng.normal(size=Y.shape)
    y_std = np.exp(0.3 * rng.normal(size=Y.shape))
    got = analysis.y_metrics(torch.as_tensor(y_mean),
                             torch.as_tensor(y_std), torch.as_tensor(Y))
    ref = {"relerr_y": jax.vmap(jlk.relative_error)(y_mean, Y).mean(),
           "logscore_y": jax.vmap(jlk.predictive_logscore)(
               Y, y_mean, y_std).mean(),
           "r2_y": jlk.coefficient_of_determination(y_mean, Y)}
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-10)
    X = rng.normal(size=(6, 4, 4))
    x_mean = X.reshape(6, -1) + 0.1 * rng.normal(size=(6, 16))
    x_std = np.exp(0.2 * rng.normal(size=(6, 16)))
    got = analysis.x_metrics(torch.as_tensor(x_mean), torch.as_tensor(x_std),
                             torch.as_tensor(X))
    np.testing.assert_allclose(
        got["relerr_x"].numpy(),
        jax.vmap(jlk.relative_error)(x_mean, X.reshape(6, -1)).mean(),
        rtol=1e-10)
    np.testing.assert_allclose(
        got["logscore_x"].numpy(),
        jax.vmap(jlk.predictive_logscore)(X.reshape(6, -1), x_mean,
                                          x_std).mean(), rtol=1e-10)


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("spec,steps", [
    ({"milestones": [3, 7], "factor": 0.5}, 1),
    ({"milestones": [10, 11], "factor": 0.5}, 0.1),   # collide at count 1
    ({"step_size": 4, "factor": 0.3}, 1),
    (None, 1)])
def test_schedules_match_optax(spec, steps):
    t = make_schedule(spec, 1e-2, steps_per_update=steps)
    j = jsch.make_schedule(spec, 1e-2, steps_per_update=steps)
    for count in range(12):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-12)


def test_multistep_lr_colliding_milestones_accumulate():
    s = multistep_lr(1.0, [10, 11], 0.5, steps_per_update=0.1)
    assert s(0) == 1.0 and s(1) == 0.25 and s(5) == 0.25
    with pytest.raises(ValueError, match="learning rate is unset"):
        make_schedule(None, None)


# ------------------------------------------------------------- data loader
@pytest.fixture()
def fields():
    rf = tfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = rf.sample(torch.Generator().manual_seed(0), batch_size=28,
                  dtype=torch.float64, device="cpu").numpy()
    return X


def test_dataloader_partitions_match_jax(fields):
    jphys = jfem.make_fom_rom_pair("NDP", 4, 4, 3)
    tphys = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    dj, dt = JDataLoader(fields.copy()), DataLoader(fields.copy())
    assert dj.hash == dt.hash
    # 28 fields in dispatches of 16: the tail of the second is padded
    dj.assemble(jphys, rng=np.random.default_rng(0), label_batch=16)
    dt.assemble(tphys, rng=np.random.default_rng(0), label_batch=16)
    assert dt.Y.shape == (28, tphys["fom"].dim_out)
    np.testing.assert_allclose(dt.Y, dj.Y, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(dt.X_DG, dj.X_DG)
    np.testing.assert_array_equal(dt.F_ROM_BC, dj.F_ROM_BC)
    for d in (dj, dt):
        d.randomized_partition({"supervised": 12, "validation": 8},
                               rng=np.random.default_rng(1))
    ds = dt.construct_dataset_dictionary(identifier="default",
                                         dtype=torch.float32, device="cpu")
    sup, val = ds["supervised"], ds["validation"]
    np.testing.assert_array_equal(sup.indices, dj._permutation["default"][
        :12])
    assert sup.N == 12 and val.N == 8
    assert set(sup.indices).isdisjoint(set(val.indices))
    assert sup.get("X").dtype == torch.float32
    sup.restrict(6)
    assert sup.N == 6 and sup.get("X").shape[0] == 6
    assert len(sup.get("BCE")) == 6
    sup.restrict(12)
    sup.grow_in_size(4, incremental=True)
    assert sup.N == 16
    with pytest.raises(ValueError):
        sup.grow_in_size(100, incremental=True)
    with pytest.raises(ValueError):
        sup.restrict(-1)
    y0 = tphys["fom"].solve_direct(np.exp(dt.X_DG[0]),
                                   dt.BCE.constrained_values("fom")[0])
    np.testing.assert_allclose(dt.Y[0], y0, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="permutation"):
        dt.randomized_partition({"a": 2}, identifier="x",
                                permutation=np.zeros(28))


def test_assemble_bool_mask_rows(fields):
    """rows=<bool mask> honours mask semantics; the tail of the last
    dispatch is padded."""
    tphys = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    dl = DataLoader(fields.copy())
    mask = np.zeros(dl.N, dtype=bool)
    mask[[1, 4]] = True
    dl.assemble(tphys, rows=mask, label_batch=8)
    assert np.isfinite(dl.Y[[1, 4]]).all()
    assert np.isnan(dl.Y[np.flatnonzero(~mask)]).all()


# ------------------------------------------------------ port-only smoke
def test_trainer_smoke_ten_steps(fields):
    p = TrainerParameters()
    p.identifier = "highres32"
    p.debug = True
    p.trainer["lr_init"] = 1e-2
    p.scheduler = {"milestones": [5], "factor": 0.5}
    p.data.update(N_u=16, N_s=12, N_u_max=16, N_s_max=12, N_val=8,
                  armortized_bs=8)
    dl = DataLoader(fields[:20])
    dlu = DataLoader(fields[12:28])
    dlu.lock_physics_assembly()
    trainer = CreateTrainer(p, dl, dlu, device="cpu")
    trainer.run(10, verbose=False)
    elbos = trainer.elbos()
    assert elbos.shape == (10,) and bool(torch.isfinite(elbos).all())
    res = trainer.results()
    assert all(np.isfinite(res[k]) for k in ("relerr_y", "r2_y",
                                             "logscore_y"))
    assert trainer.writer.scalars["validation/relerr_y"]
    bundle = trainer.export_surrogate()
    y = bundle.predict(fields[:3], dl.F_ROM_BC[:3])
    assert y.shape == (3, trainer.physics["fom"].dim_out)
    assert bool(torch.isfinite(y).all())
