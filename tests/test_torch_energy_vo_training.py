"""BASELINE config 2e (config 2 with the energy virtual observables) at a
32^2 stand-in, three f64 SVI steps across an energy update, in the port's
trainer against the JAX package.

The recipe is the one ``examples/torch_baseline_configs.py`` ``config2e``
builds (the 'highres' preset, channel dropout 0.2, the amortized
unlabeled term, ``vo_spec_preset("energy", T_iterations=1001)``: 32 RBF
test functions, 10 subspace iterations an update, the exponential
temperature schedule; update interval 10), with the stand-in of
``tests/test_torch_baseline_configs.py`` (a 4^2 ROM refined 3 times,
decoder blocks (1, 2), f64; 6 supervised, 4 VO, 4 validation and 8
unlabeled fields, 4 VO Monte-Carlo samples) and the holdoff cut from 50 to
1: step 0 holds the VO term off, step 1 propagates the moments and runs
the first energy update before its gradient step, step 2 steps on the
updated VO posterior (the next update would come at step 10).

Draws are injected as in that file's config 2 test (one numpy stream per
side, channel masks from another; each JAX step traced afresh).  The JAX
energy update runs under ``jax.disable_jit()``: its ``fori_loop`` then
draws the test functions of each subspace iteration anew, as the port's
loop does.  Tolerance 1e-7 (f64): ELBOs, parameters, BatchNorm statistics
and the VO posterior's mean and variances, as the port's other three-step
tests.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.constraints import (
    virtual_observables as jvo)
from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.training import schedules as jsch
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.constraints import (
    EnergyVirtualObservablesEnsemble)
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, Trainer)
from test_torch_baseline_configs import (BS, N_MC, N_S, N_U, N_VAL, N_VO,
                                         STAND_IN, _inject, _module, _np,
                                         _perturb, _record, _rel)

TOL = 1e-7


def test_config2e_stand_in_three_steps_across_an_energy_update_match_jax(
        monkeypatch):
    tmod = _module("torch_baseline_configs")
    rec = _record(monkeypatch, tmod)
    tmod.config2e()
    p = rec["params"]
    spec = p.data["vo_spec"]
    assert p.identifier == "highres" and spec["type"] == "energy" \
        and spec["T_iterations"] == 1001 \
        and p.trainer["N_vo_update_interval"] == 10
    p.margs.update(STAND_IN)
    p.trainer.update(N_PE_updates=0, N_monitor_interval=0,
                     N_monte_carlo_vo=N_MC, N_vo_holdoff=1)
    p.data.update(N_u=N_U, N_s=N_S, N_vo=N_VO, N_u_max=N_U, N_s_max=N_S,
                  N_vo_max=N_VO, N_val=N_VAL, armortized_bs=BS)
    lr = p.trainer["lr_init"]

    jphys, jm, _, _, _ = jmf.highres(**STAND_IN).setup()
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
    assert isinstance(trainer.VO, EnergyVirtualObservablesEnsemble)
    load_flax_variables(trainer.model, params, bs)
    refreshes = []
    refresh = Trainer.update_virtual_observables

    def counted(self, step, resample=True):
        refreshes.append(step)
        return refresh(self, step, resample)

    monkeypatch.setattr(Trainer, "update_virtual_observables", counted)

    class FakeDS:
        def get(self, key):
            return {"X_DG": jnp.asarray(X_DG[N_S:N_S + N_VO]),
                    "BCE": jbce[list(range(N_S, N_S + N_VO))]}[key]

    jvo_ens = jvo.build_virtual_observables_ensemble(spec, FakeDS(), jphys,
                                                     dtype=jnp.float64)
    jidx, mask_shapes = _inject(monkeypatch, 37)
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
        if gn == 1:  # the first chance after the holdoff: one update
            Y_mean, Y_std = jm.propagate_vo_moments(
                jp, data_vo, jax.random.PRNGKey(0), N_MC)
            jvo_ens.resample(jax.random.PRNGKey(0))
            with jax.disable_jit():  # each subspace iteration draws anew
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
    assert refreshes == [1]
    assert trainer.VO.temperature == jvo_ens.temperature < 1.0
    assert mask_shapes["t"] == mask_shapes["j"] and mask_shapes["t"]
    assert _rel(trainer.elbos().numpy(), elbos_j) <= TOL
    for name in ("mean", "vars"):
        assert _rel(getattr(trainer.VO, name), getattr(jvo_ens, name)) \
            <= TOL, name
    ref = copy.deepcopy(trainer.model)
    load_flax_variables(ref, _np(jp), _np(jbs))
    want = dict(ref.named_parameters())
    for name, prm in trainer.model.named_parameters():
        assert _rel(prm.detach().numpy(), want[name].detach().numpy()) \
            <= TOL, name
    want = dict(ref.named_buffers())
    for name, b in trainer.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert _rel(b.numpy(), want[name].numpy()) <= TOL, name
