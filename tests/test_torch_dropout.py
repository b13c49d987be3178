"""Seeded channel dropout of the port against Flax ``Dropout(rate,
broadcast_dims=(1, 2))`` in the JAX package, on a 16^2 stand-in for the
'highres' architecture: decoder and encoder blocks (1, 2, 1), growth 4,
6 initial features, ``droprate=0.2``, 'ND' boundary conditions, a 4^2 ROM
refined twice.

Shared masks: the port draws every mask through
``models.codec.dropout_mask`` and Flax through ``jax.random.bernoulli``;
both are replaced by functions that hand out the same numpy Bernoulli(0.8)
channel masks in call order ((N, C, 1, 1) on the port's NCHW side,
(N, 1, 1, C) on Flax's NHWC side), and the tests check that both packages
asked for the same sequence of shapes.  The other draws are injected as in
``tests/test_torch_training.py`` (``variational.sample``,
``generative.reparametrize``, ``trainer.minibatch_indices``), and each JAX
evaluation is traced afresh.

Tolerances (f64): decoder and encoder outputs 1e-8, the ELBO and its
gradients 1e-8, three SVI steps (ELBOs, parameters, BatchNorm statistics)
1e-7, as in the dropout-free training tests.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.models.decoder import (
    CNNDecoder as JDecoder)
from generative_physics_informed_pde_tpu.models.encoder import (
    CNNEncoder as JEncoder)
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.factories import model as tmf
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import codec as tcodec
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

LATENT, RATE = 8, 0.2
N_S, N_U, N_VAL, BS = 6, 8, 4, 4
# dropout layers per train-mode pass of the (1, 2, 1) codecs: a mask after
# each dense layer, two in each transition, one in the last decoding
DECODER_MASKS, ENCODER_MASKS = 9, 10


class JStandIn(jmf.highres):
    """The 'highres' codec widths at 16^2 (latent image 2^2)."""

    def __init__(self, **kw):
        super().__init__(nx_rom=4, ny_rom=4, num_refines=2,
                         dim_latent=LATENT, **kw)

    def setup(self):
        physics = self._setup_physics()
        dec = JDecoder(target_img_size=16, dim_latent=LATENT,
                       latent_img_size=2, latent_img_features=1,
                       init_features=6, blocks=(1, 2, 1), growth_rate=4,
                       drop_rate=RATE)
        enc = JEncoder(imsize=16, latent_dim=LATENT, blocks=(1, 2, 1),
                       growth_rate=4, init_features=6, drop_rate=RATE)
        return self._closure(physics, enc, dec)


class TStandIn(tmf.highres):
    _decoder = dict(tmf.highres._decoder, latent_img_size=2)

    def __init__(self, **kw):
        super().__init__(**{"nx_rom": 4, "ny_rom": 4, "num_refines": 2,
                            "dim_latent": LATENT, **kw})


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Masks:
    """Bernoulli channel masks in call order from one numpy seed, with the
    (N, C) shapes asked for."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def draw(self, n, c, keep):
        self.shapes.append((n, c))
        return self.rng.random((n, c)) < keep


def _inject_masks(monkeypatch, seed):
    mj, mt = Masks(seed), Masks(seed)

    def j_bernoulli(key, p=0.5, shape=None):
        n, _, _, c = shape
        return jnp.asarray(mj.draw(n, c, p).reshape(n, 1, 1, c))

    def t_mask(shape, keep, generator, device):
        n, c = shape[0], shape[1]
        return torch.as_tensor(mt.draw(n, c, keep).reshape(n, c, 1, 1),
                               device=device)

    monkeypatch.setattr(jax.random, "bernoulli", j_bernoulli)
    monkeypatch.setattr(tcodec, "dropout_mask", t_mask)
    return mj, mt


def _inject_draws(monkeypatch, seed):
    """Same-order normals and minibatch indices for both packages."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)

    def j_sample(params, key):
        eps = jnp.asarray(rj.standard_normal(params["logsigma"].shape))
        return params["mean"] + jnp.exp(params["logsigma"]) * eps

    def j_reparametrize(key, mean, logsigma):
        return mean + jnp.exp(logsigma) * jnp.asarray(
            rj.standard_normal(logsigma.shape))

    def t_sample(params, generator=None):
        eps = torch.as_tensor(rt.standard_normal(
            tuple(params["logsigma"].shape)))
        return params["mean"] + torch.exp(params["logsigma"]) * eps

    def t_reparametrize(generator, mean, logsigma):
        return mean + torch.exp(logsigma) * torch.as_tensor(
            rt.standard_normal(tuple(logsigma.shape)))

    def t_minibatch(generator, num_data, batch_size, device=None):
        return torch.as_tensor(rt.permutation(num_data)[:batch_size])

    monkeypatch.setattr(jva, "sample", j_sample)
    monkeypatch.setattr(jgen, "reparametrize", j_reparametrize)
    monkeypatch.setattr(tva, "sample", t_sample)
    monkeypatch.setattr(tgen, "reparametrize", t_reparametrize)
    monkeypatch.setattr(ttrainer, "minibatch_indices", t_minibatch)
    return lambda n, k: jnp.asarray(rj.permutation(n)[:k])


def _perturb(tree, rng):
    """Random BatchNorm scales/statistics, posteriors and logsigmas, f64."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, dtype=np.float64)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean", "logsigma") or k.startswith("logsigmas"):
            v = 0.1 * rng.normal(size=v.shape)
        out[k] = v
    return out


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def setting():
    rf = jfem.GaussianRandomField.from_image(16, 16, 0.4, 0.8, 0.15)
    rng = np.random.default_rng(0)
    gamma = rng.standard_normal((N_S + N_VAL + N_U, rf.dim_in))
    X = np.array(rf.sample(None, gamma=jnp.asarray(gamma),
                           dtype=jnp.float64))
    physics, jmodel, _, _, _ = JStandIn(dtype="float64").setup()
    bce = jfem.BoundaryConditionEnsemble.from_factory(
        "ND", N_S + N_VAL, np.random.default_rng(1))
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
         "unsupervised": {"X": jnp.asarray(data["X_u"])}}, (16, 16))
    prng = np.random.default_rng(2)
    params = _perturb(_to_np(params), prng)
    for q in (params["q_z"]["supervised"], params["q_X"]["supervised"]):
        q["logsigma"] = -1.0 + 0.1 * prng.normal(size=q["logsigma"].shape)
    bs = _perturb(_to_np(bs), prng)
    return jmodel, params, bs, data


def _port_model(params, bs, data):
    _, model, _, _, dtype = TStandIn(dtype="float64").setup(device="cpu")
    assert dtype == torch.float64
    model.init_params({"supervised": {"X": data["X_s"]},
                       "unsupervised": {"X": data["X_u"]}})
    return load_flax_variables(model, params, bs)


def _named(model, params, bs):
    """The port's parameters and BatchNorm statistics with the values of
    a Flax tree."""
    g = copy.deepcopy(model)
    load_flax_variables(g, params, bs)
    return dict(g.named_parameters()), {
        n: b for n, b in g.named_buffers()
        if n.endswith(("running_mean", "running_var"))}


def _stats(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def test_dropout_masks_come_from_the_callers_generator():
    x = torch.ones(6, 5, 3, 3)
    state = torch.get_rng_state()
    a = tcodec.channel_dropout(x, RATE, True, torch.Generator().manual_seed(4))
    b = tcodec.channel_dropout(x, RATE, True, torch.Generator().manual_seed(4))
    c = tcodec.channel_dropout(x, RATE, True, torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)  # global RNG untouched
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a[:, :, 0, 0]
    assert set(kept.unique().tolist()) <= {0.0, 1 / (1 - RATE)}
    # whole channels: one value per (sample, channel)
    assert torch.equal(a, kept[:, :, None, None].expand_as(a))
    assert torch.equal(tcodec.channel_dropout(x, RATE, False), x)
    with pytest.raises(ValueError, match="Generator"):
        tcodec.channel_dropout(x, RATE, True)  # no unseeded fallback


def test_codec_dropout_matches_flax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    model = _port_model(params, bs, data)
    mj, mt = _inject_masks(monkeypatch, 5)
    z = np.random.default_rng(4).normal(size=(6, LATENT))
    (dj, lj), _ = jax.jit(lambda v, z: jmodel.f.apply(
        v, z, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        {"params": params["f"], "batch_stats": bs["f"]}, jnp.asarray(z))
    dt, lt = model.apply_decoder(torch.as_tensor(z), train=True)
    assert _rel(dt.detach().numpy(), dj) <= 1e-8
    assert _rel(lt.detach().numpy(), lj) <= 1e-8
    x = data["X_u"][:6]
    (ej, sj), _ = jax.jit(lambda v, x: jmodel.encoder.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)}))(
        {"params": params["encoder"], "batch_stats": bs["encoder"]},
        jnp.asarray(x))
    et, st = model.apply_encoder(torch.as_tensor(x), train=True)
    assert _rel(et.detach().numpy(), ej) <= 1e-8
    assert _rel(st.detach().numpy(), sj) <= 1e-8
    assert mt.shapes == mj.shapes
    assert len(mt.shapes) == DECODER_MASKS + ENCODER_MASKS
    # eval mode (analysis, serving) draws no mask
    model.apply_decoder(torch.as_tensor(z), train=False)
    model.apply_encoder(torch.as_tensor(x), train=False)
    assert len(mt.shapes) == DECODER_MASKS + ENCODER_MASKS


def test_elbo_with_dropout_matches_jax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    model = _port_model(params, bs, data)
    _inject_draws(monkeypatch, 11)
    mj, mt = _inject_masks(monkeypatch, 12)
    sup = ("X", "Y", "F_ROM_BC")
    arrays = {"supervised": [data["X_s"], data["Y_s"], data["F_s"]],
              "unsupervised": [data["X_u"][:BS]]}
    jdata = {"supervised": dict(zip(sup, map(jnp.asarray,
                                             arrays["supervised"]))),
             "unsupervised": {"X": jnp.asarray(arrays["unsupervised"][0])}}
    tdata = {"supervised": dict(zip(sup, map(torch.as_tensor,
                                             arrays["supervised"]))),
             "unsupervised": {"X": torch.as_tensor(
                 arrays["unsupervised"][0])}}

    def loss(p):
        e, new_bs, logs = jmodel.elbo(p, bs, jdata, jax.random.PRNGKey(0),
                                      l2_penalty=1e-3)
        return e, (new_bs, logs)

    (ej, (bs_j, logs_j)), gj = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    et, logs_t = model.elbo(tdata, None, l2_penalty=1e-3)
    et.backward()
    # encoder and decoder of the unlabeled term, then the labeled decode
    assert mt.shapes == mj.shapes
    assert len(mt.shapes) == ENCODER_MASKS + 2 * DECODER_MASKS
    assert _rel(et.detach().numpy(), ej) <= 1e-8
    for k in ("supervised_logL_x", "supervised_logL_y",
              "ARM_unsupervised_logL_x", "ARM_unsupervised_DKL_z"):
        assert _rel(logs_t[k].detach().numpy(), logs_j[k]) <= 1e-8, k
    want, want_stats = _named(model, _to_np(gj), _to_np(bs_j))
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want[name].detach().numpy()) <= 1e-8, \
            name
    for name, b in _stats(model).items():
        assert _rel(b.numpy(), want_stats[name].numpy()) <= 1e-8, name


def test_three_svi_steps_with_dropout_match_jax(setting, monkeypatch):
    jmodel, params, bs, data = setting
    lr, milestones, factor = 1e-2, [1, 2], 0.5
    monkeypatch.setitem(tmf._REGISTRY, "standin16", TStandIn)
    p = TrainerParameters()
    p.identifier = "standin16"
    p.margs["dtype"] = "float64"
    p.trainer.update(lr_init=lr, N_PE_updates=0, N_monitor_interval=0)
    p.scheduler = {"milestones": milestones, "factor": factor}
    p.data.update(N_u=N_U, N_s=N_S, N_u_max=N_U, N_s_max=N_S, N_val=N_VAL,
                  armortized_bs=BS)
    dl = DataLoader(np.concatenate([data["X_s"], data["X_val"]]),
                    Y=np.concatenate([data["Y_s"], data["Y_val"]]),
                    F_ROM_BC=np.concatenate([data["F_s"], data["F_val"]]))
    trainer = CreateTrainer(p, dl, DataLoader(data["X_u"]), device="cpu")
    load_flax_variables(trainer.model, params, bs)
    assert trainer.model.f.DenseBlock_0.DenseLayer_0.drop_rate == RATE
    jidx = _inject_draws(monkeypatch, 23)
    mj, mt = _inject_masks(monkeypatch, 24)

    opt = optax.adam(jsch.make_schedule(
        {"milestones": milestones, "factor": factor}, lr))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": jnp.asarray(data["X_s"]), "Y": jnp.asarray(data["Y_s"]),
           "F_ROM_BC": jnp.asarray(data["F_s"])}
    X_u = jnp.asarray(data["X_u"])
    elbos_j = []
    for _ in range(3):
        d = {"supervised": sup, "unsupervised": {"X": X_u[jidx(N_U, BS)]}}

        def loss(q):
            e, new_bs, _ = jmodel.elbo(q, jbs, d, jax.random.PRNGKey(0))
            return -e, new_bs

        (neg, jbs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        updates, opt_state = opt.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        elbos_j.append(float(-neg))

    for _ in range(3):
        trainer.step()
    assert mt.shapes == mj.shapes
    assert len(mt.shapes) == 3 * (ENCODER_MASKS + 2 * DECODER_MASKS)
    np.testing.assert_allclose(trainer.elbos().numpy(), elbos_j, rtol=1e-7)
    want, want_stats = _named(trainer.model, _to_np(jp), _to_np(jbs))
    for name, q in trainer.model.named_parameters():
        assert _rel(q.detach().numpy(), want[name].detach().numpy()) <= 1e-7,\
            name
    for name, b in _stats(trainer.model).items():
        assert _rel(b.numpy(), want_stats[name].numpy()) <= 1e-7, name
