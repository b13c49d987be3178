"""Does the bf16 unlabeled ELBO term move as far from its f32 value in the
JAX package as in the port once the model has trained?

BASELINE config 3 runs its unlabeled term's codec in bf16 (the 'auto'
gate at >= 128^2).  The JAX package's own check of that gate
(``tests/test_models.py`` ``test_unsup_compute_dtype_scoped_to_unsup_term``)
bounds the move at 0.2 relative at a random init.  Here both packages
start from the same Flax weights of a config 3 stand-in
(``highres128(nx_rom=4, ny_rom=4, num_refines=3)``: 32^2 fields, the
preset's codec widths), take three f64 SVI steps (4 ELBO samples, Adam
at 1e-2, ten times config 3's rate so that the state leaves the init)
under injected draws, and are held to each other there (1e-7, as
``tests/test_torch_config3_training.py``).  Then each package's trained
state, in f32, evaluates its train-mode unlabeled term on the same 16
fields with the same draws, once with the codec in bf16 and once in f32.

Measured on the CPU: the relative move |bf16 - f32| / |f32| is 3.809e-04
in the JAX package and 3.746e-04 in the port at the trained state
(1.502e-03 and 2.499e-04 at the init): at this state the port's bf16 term
moves as far as the JAX package's, and neither moves further than at the
init.  Bound: the port's move within 1.5 times the JAX package's, plus
1e-3.
"""

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
from generative_physics_informed_pde_tpu_torch.factories import model as tmf
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.training import (
    trainer as ttrainer)

N_S, N_U, N_VAL, BS, N_MC, LR = 4, 16, 3, 4, 4, 1e-2
STAND_IN = dict(nx_rom=4, ny_rom=4, num_refines=3)
MOVE_FACTOR, MOVE_SLACK = 1.5, 1e-3


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(tree, dtype=np.float64):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _inject(monkeypatch, seed):
    """One numpy stream of normals per shape on each side, and one of
    minibatch indices: the same draws in both packages."""
    streams = {}

    def normal(side, shape):
        shape = tuple(int(s) for s in shape)
        if (side, shape) not in streams:
            streams[side, shape] = np.random.default_rng([seed, *shape])
        return streams[side, shape].standard_normal(shape)

    idx = {side: np.random.default_rng([seed, 99]) for side in "jt"}

    def j_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jnp.asarray(
            normal("j", (m.shape[0], n, m.shape[-1])), ls.dtype)

    def t_all(params, generator, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * torch.as_tensor(
            normal("t", (m.shape[0], n, m.shape[-1])), dtype=ls.dtype)

    for mod, name, fn in (
            (jva, "sample", lambda p, key: p["mean"] + jnp.exp(
                p["logsigma"]) * jnp.asarray(normal("j", p["logsigma"].shape),
                                             p["logsigma"].dtype)),
            (jva, "sample_all_components", j_all),
            (jgen, "reparametrize", lambda key, m, ls: m + jnp.exp(ls)
             * jnp.asarray(normal("j", ls.shape), ls.dtype)),
            (tva, "sample", lambda p, g=None: p["mean"] + torch.exp(
                p["logsigma"]) * torch.as_tensor(
                    normal("t", p["logsigma"].shape),
                    dtype=p["logsigma"].dtype)),
            (tva, "sample_all_components", t_all),
            (tgen, "reparametrize", lambda g, m, ls: m + torch.exp(ls)
             * torch.as_tensor(normal("t", ls.shape), dtype=ls.dtype)),
            (ttrainer, "minibatch_indices",
             lambda g, n, k, device=None: torch.as_tensor(
                 idx["t"].permutation(n)[:k]))):
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
    return dataclasses.replace(jm, n_mc=N_MC), data


def _unlabeled_moves(monkeypatch, jm, jp, jbs, port_state, X_u,
                     margs=STAND_IN, seed=5):
    """(JAX move, port move): (bf16 - f32) / |f32| of each package's
    train-mode unlabeled term at its own state (the ``highres128`` preset
    with ``margs``), in f32, the same draws from ``seed``."""
    p32, b32 = _np(jp, np.float32), _np(jbs, np.float32)
    jplain = dataclasses.replace(jm, dtype=jnp.float32, n_mc=1)
    Xu = jnp.asarray(X_u, jnp.float32)
    terms = {}
    for gate in (None, jnp.bfloat16):
        jmod = dataclasses.replace(jplain, unsup_compute_dtype=gate)
        _inject(monkeypatch, seed)
        e, _, _ = jax.jit(lambda p, b, x: jmod.elbo_unsupervised_amortized(
            p, b, x, jax.random.PRNGKey(5), train=True))(p32, b32, Xu)
        terms["j", gate is not None] = float(e)
    for gate in (None, "bfloat16"):
        _, m, _, _, _ = tmf.highres128(unsup_compute_dtype=gate,
                                       **margs).setup(device="cpu")
        m.init_params({"supervised": {"X": np.zeros((N_S, 1))}})
        m.load_state_dict(port_state)
        _inject(monkeypatch, seed)
        e, _ = m.elbo_unsupervised_amortized(
            torch.as_tensor(X_u, dtype=torch.float32), None, train=True)
        terms["t", gate is not None] = float(e.detach())
    return tuple((terms[s, True] - terms[s, False]) / abs(terms[s, False])
                 for s in "jt")


def test_bf16_unlabeled_term_moves_as_far_as_jax_at_a_trained_state(
        setting, monkeypatch):
    jm, data = setting
    X_s = jnp.asarray(data["X"][:N_S])
    params, bs = jm.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": X_s},
         "unsupervised": {"X": jnp.asarray(data["X_u"])}}, (32, 32))
    params, bs = _np(params), _np(bs)

    p = TrainerParameters()
    p.identifier = "highres128"
    p.margs.update(dtype="float64", **STAND_IN)
    p.trainer.update(lr_init=LR, N_PE_updates=0, N_monitor_interval=0,
                     N_monte_carlo_elbo=N_MC)
    p.data.update(N_u=N_U, N_s=N_S, N_u_max=N_U, N_s_max=N_S, N_val=N_VAL,
                  armortized_bs=BS)
    trainer = CreateTrainer(p, DataLoader(data["X"], Y=data["Y"],
                                          F_ROM_BC=data["F"]),
                            DataLoader(data["X_u"]), device="cpu")
    load_flax_variables(trainer.model, params, bs)
    port_init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    init_moves = _unlabeled_moves(monkeypatch, jm, params, bs, port_init,
                                  data["X_u"])

    jidx = _inject(monkeypatch, 31)
    opt = optax.adam(jsch.make_schedule(None, LR))
    jp, jbs = jax.tree_util.tree_map(jnp.asarray, (params, bs))
    opt_state = opt.init(jp)
    sup = {"X": X_s, "Y": jnp.asarray(data["Y"][:N_S]),
           "F_ROM_BC": jnp.asarray(data["F"][:N_S])}
    X_u = jnp.asarray(data["X_u"])
    elbos_j = []
    for _ in range(3):
        d = {"supervised": sup, "unsupervised": {"X": X_u[jidx(N_U, BS)]}}

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

    j_move, t_move = (abs(m) for m in _unlabeled_moves(
        monkeypatch, jm, jp, jbs, trainer.model.state_dict(), data["X_u"]))
    print(f"relative bf16 move at the init: JAX {init_moves[0]:.3e}, port "
          f"{init_moves[1]:.3e}; after three steps: JAX {j_move:.3e}, port "
          f"{t_move:.3e}")
    assert 0.0 < j_move and 0.0 < t_move
    assert t_move <= MOVE_FACTOR * j_move + MOVE_SLACK


def survey(n_seeds: int = 5, n_fields: int = 16):
    """The signed move (bf16 - f32) / |f32| of the train-mode unlabeled
    term at random inits of the full ``highres128`` preset (BASELINE config
    3's widths, 128^2 fields) in both packages, the same Flax weights and
    draws, for seeds 0 .. n_seeds - 1.  Not a test (minutes on a CPU):

        JAX_PLATFORMS=cpu PYTHONPATH=. python \
            tests/test_torch_bf16_trained_state.py 5
    """
    class Patch:
        def setattr(self, mod, name, value):
            setattr(mod, name, value)

    jm = jmf.highres128().setup()[1]
    for seed in range(n_seeds):
        X_u = np.random.default_rng(seed).normal(0.4, 1.0,
                                                 (n_fields, 128, 128))
        params, bs = _np(jm.init_params(
            jax.random.PRNGKey(seed),
            {"supervised": {"X": jnp.asarray(X_u[:N_S])},
             "unsupervised": {"X": jnp.asarray(X_u)}}, (128, 128)))
        _, m, _, _, _ = tmf.highres128().setup(device="cpu")
        m.init_params({"supervised": {"X": np.zeros((N_S, 1))}})
        load_flax_variables(m, params, bs)
        moves = _unlabeled_moves(Patch(), jm, params, bs, m.state_dict(),
                                 X_u, margs={}, seed=5 + seed)
        print(f"seed {seed}: JAX {moves[0]:+.4f}, port {moves[1]:+.4f}",
              flush=True)


if __name__ == "__main__":
    import sys

    survey(*(int(a) for a in sys.argv[1:3]))
