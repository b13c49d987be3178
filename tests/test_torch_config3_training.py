"""BASELINE config 3's training options in the port's trainer against the
JAX package: three f64 SVI steps with ``N_monte_carlo_elbo=4`` on a
``highres128`` stand-in (``nx_rom=ny_rom=4, num_refines=3``: 32^2
fields), with the amortized encoder and without it (``use_encoder=False``, the
non-amortized unlabeled term over the whole unlabeled chunk), under
injected draws; the plateau schedule's controller against JAX's on the
same metric series; and a port-only run of the trainer with the plateau
schedule, a bf16 prediction-ensemble decode and four ELBO samples.

Draws: one numpy stream per shape on each side (the posteriors' and the
reparametrised draws), and one stream of minibatch indices; each JAX step
is traced afresh (a replaced sampler runs at trace time) and composes Adam
with ``optax.adam(make_schedule(...))`` as the JAX trainer's step does.

Tolerances (f64): the ELBO trajectory, the parameters and the BatchNorm
statistics after three steps 1e-7 (torch's Adam and optax round the
bias-corrected step differently); the plateau scales exactly.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.fem import randomfield as trf
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, PlateauController, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

N_S, N_U, N_VAL, BS, N_MC = 4, 6, 3, 4, 4
STAND_IN = dict(nx_rom=4, ny_rom=4, num_refines=3)


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


def _inject(monkeypatch, seed):
    """Per-shape normals and one index stream, the same on both sides."""
    streams = {}

    def normal(side, shape):
        shape = tuple(int(s) for s in shape)
        key = (side, shape)
        if key not in streams:
            streams[key] = np.random.default_rng([seed, *shape])
        return streams[key].standard_normal(shape)

    idx = {side: np.random.default_rng([seed, 99]) for side in "jt"}

    def j_sample(params, key):
        ls = params["logsigma"]
        return params["mean"] + jnp.exp(ls) * jnp.asarray(
            normal("j", ls.shape))

    def j_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jnp.asarray(
            normal("j", (m.shape[0], n, m.shape[-1])))

    def j_rep(key, mean, logsigma):
        return mean + jnp.exp(logsigma) * jnp.asarray(
            normal("j", logsigma.shape))

    def t_sample(params, generator=None):
        ls = params["logsigma"]
        return params["mean"] + torch.exp(ls) * torch.as_tensor(
            normal("t", ls.shape))

    def t_all(params, generator, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * torch.as_tensor(
            normal("t", (m.shape[0], n, m.shape[-1])))

    def t_rep(generator, mean, logsigma):
        return mean + torch.exp(logsigma) * torch.as_tensor(
            normal("t", logsigma.shape))

    def t_minibatch(generator, num_data, batch_size, device=None):
        return torch.as_tensor(idx["t"].permutation(num_data)[:batch_size])

    for mod, name, fn in ((jva, "sample", j_sample),
                          (jva, "sample_all_components", j_all),
                          (jgen, "reparametrize", j_rep),
                          (tva, "sample", t_sample),
                          (tva, "sample_all_components", t_all),
                          (tgen, "reparametrize", t_rep),
                          (ttrainer, "minibatch_indices", t_minibatch)):
        monkeypatch.setattr(mod, name, fn)
    return lambda n, k: jnp.asarray(idx["j"].permutation(n)[:k])


@pytest.fixture(scope="module")
def setting():
    jphys, jm, _, _, _ = jmf.highres128(dtype="float64", **STAND_IN).setup()
    rng = np.random.default_rng(0)
    n = N_S + N_VAL
    data = {"X": rng.normal(0.4, 0.8, (n, 32, 32)),
            "Y": rng.normal(0.0, 0.3, (n, jm.g.dim_out)),
            "F": rng.normal(0.0, 1.0, (n, jphys["rom"].grid.n_nodes)),
            "X_u": rng.normal(0.4, 0.8, (N_U, 32, 32))}
    return jm, data


@pytest.mark.parametrize("amortized", [True, False])
def test_three_svi_steps_with_four_mc_samples_match_jax(setting, amortized,
                                                        monkeypatch):
    jm, data = setting
    jm = dataclasses.replace(jm, n_mc=N_MC)
    if not amortized:
        jm = dataclasses.replace(jm, encoder=None)
    params, bs = jm.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(data["X"][:N_S])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])}}, (32, 32))
    prng = np.random.default_rng(2)
    params, bs = _perturb(_np(params), prng), _perturb(_np(bs), prng)
    lr, milestones, factor = 1e-2, [1, 2], 0.5

    p = TrainerParameters()
    p.identifier = "highres128"
    p.margs.update(dtype="float64", use_encoder=amortized, **STAND_IN)
    p.trainer.update(lr_init=lr, N_PE_updates=0, N_monitor_interval=0,
                     N_monte_carlo_elbo=N_MC)
    p.scheduler = {"milestones": milestones, "factor": factor}
    p.data.update(N_u=N_U, N_s=N_S, N_u_max=N_U, N_s_max=N_S, N_val=N_VAL,
                  armortized_bs=BS if amortized else None)
    dl = DataLoader(data["X"], Y=data["Y"], F_ROM_BC=data["F"])
    dlu = DataLoader(data["X_u"])
    trainer = CreateTrainer(p, dl, dlu, device="cpu")
    assert trainer.model.n_mc == N_MC
    assert (trainer.model.encoder is not None) == amortized
    load_flax_variables(trainer.model, params, bs)
    jidx = _inject(monkeypatch, 31)

    opt = optax.adam(jsch.make_schedule(
        {"milestones": milestones, "factor": factor}, lr))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": jnp.asarray(data["X"][:N_S]),
           "Y": jnp.asarray(data["Y"][:N_S]),
           "F_ROM_BC": jnp.asarray(data["F"][:N_S])}
    X_u = jnp.asarray(data["X_u"])
    elbos_j = []
    for _ in range(3):
        X_batch = X_u[jidx(N_U, BS)] if amortized else X_u
        d = {"supervised": sup, "unsupervised": {"X": X_batch}}

        def loss(q):
            e, new_bs, _ = jm.elbo(q, jbs, d, jax.random.PRNGKey(0))
            return -e, new_bs

        (neg, jbs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        updates, opt_state = opt.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        elbos_j.append(float(-neg))

    for _ in range(3):
        trainer.step()
    assert _rel(trainer.elbos().numpy(), elbos_j) <= 1e-7
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


# ------------------------------------------------------------- plateau
@pytest.mark.parametrize("kw", [
    dict(patience=1, threshold=1e-3, factor=0.5, min_lr=1e-4, mode="max"),
    dict(patience=0, threshold=0.5, factor=0.1, min_lr=1e-3, mode="max"),
    dict(patience=2, threshold=1e-2, factor=0.3, min_lr=1e-5, mode="min"),
])
def test_plateau_controller_matches_jax(kw):
    rng = np.random.default_rng(sum(map(ord, kw["mode"])) + kw["patience"])
    # a rising series with plateaus and drops
    series = np.concatenate([np.cumsum(rng.uniform(0, 1, 6)),
                             np.full(5, 6.0), rng.normal(5.0, 0.3, 8),
                             np.linspace(7, 8, 4), np.full(6, 8.0)])
    j = jsch.PlateauController(lr_init=1e-2, **kw)
    t = PlateauController(lr_init=1e-2, **kw)
    for i, m in enumerate(series):
        assert t.step(m) == j.step(m), i
        assert (t.best, t.bad_steps, t.scale) == (j.best, j.bad_steps,
                                                  j.scale)
    assert t.state_dict() == j.state_dict()
    fresh = PlateauController(lr_init=1e-2, **kw)
    fresh.load_state_dict(t.state_dict())
    assert (fresh.best, fresh.bad_steps, fresh.scale) == (t.best,
                                                          t.bad_steps,
                                                          t.scale)
    empty = PlateauController(lr_init=1e-2, **kw)
    empty.load_state_dict(PlateauController(lr_init=1e-2,
                                            **kw).state_dict())
    assert empty.best is None


def test_trainer_plateau_bf16_pe_and_mc_samples():
    """The trainer steps the plateau controller on the ELBO at each
    monitor point and sets Adam's lr to lr_init * scale, records that lr,
    and builds the prediction ensemble's schedule as a constant; it takes
    a bf16 prediction-ensemble decode and four ELBO samples."""
    rf = trf.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = rf.sample(torch.Generator().manual_seed(0), batch_size=28,
                  dtype=torch.float64, device="cpu").numpy()
    spec = {"patience": 0, "threshold": 1e9, "factor": 0.5, "min_lr": 1e-3}
    p = TrainerParameters()
    p.identifier = "highres32"
    p.trainer.update(lr_init=1e-2, N_monitor_interval=2, N_PE_updates=1,
                     N_PE_updates_final=2, N_monte_carlo_analysis=4,
                     N_monte_carlo_analysis_final=4, N_monte_carlo_elbo=4,
                     PE_compute_dtype="bfloat16")
    p.scheduler = dict(spec)
    p.data.update(N_u=16, N_s=12, N_u_max=16, N_s_max=12, N_val=8,
                  armortized_bs=8)
    dl = DataLoader(X[:20])
    dlu = DataLoader(X[12:28])
    dlu.lock_physics_assembly()
    trainer = CreateTrainer(p, dl, dlu, device="cpu")
    assert trainer.model.n_mc == 4
    assert trainer._PE.compute_dtype == torch.bfloat16
    assert trainer._PE.schedule(0) == trainer._PE.schedule(10 ** 6) == 1e-2
    trainer.run(9, verbose=False)
    elbos = trainer.elbos().numpy()
    assert elbos.shape == (9,) and np.isfinite(elbos).all()
    ref = jsch.PlateauController(lr_init=1e-2, **spec)
    want = [(n, 1e-2 * ref.step(elbos[n])) for n in (2, 4, 6, 8)]
    got = [(s - 1, v) for s, v in trainer.writer.scalars["Monitoring/lr"]]
    assert got == want
    assert [g["lr"] for g in trainer.optimizer.param_groups] \
        == [want[-1][1]]
    res = trainer.results()
    assert all(np.isfinite(res[k]) for k in ("relerr_y", "r2_y",
                                             "logscore_y"))
