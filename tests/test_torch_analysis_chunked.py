"""The port's streamed Monte-Carlo analysis against the JAX package's.

``Analysis.eval_all_y`` / ``eval_all_x`` split the Monte-Carlo axis into
equal chunks when N x S x dim exceeds an element budget (2^27 for y, 2^24
for x), and round the sample count up to fill them: the metrics then
average over ``S_eff = chunk * n_chunks`` samples, not S.

1. ``_mc_chunk`` against the JAX function over the BASELINE configs'
   validation pools and Monte-Carlo counts (monitor and final analyses at
   128^2, 256^2 and 512^2).  Counted per grid node a label would be
   (257^2 x 32 at 256^2), S_eff is 252 at 128^2, 126 / 189 at 256^2 and
   75 / 135 at 512^2.  But a label holds the free dofs only, (2^k + 1)^2
   - 2 (2^k + 1) = 4^k - 1 of them ('NDP': Dirichlet on two sides), so
   N x dim_y sits just under a power of two and the budget splits S
   evenly: the JAX package averages over S itself in every config, in 2
   chunks at 256^2's final analysis and in 4 and 8 at 512^2.  Both
   readings are held.
2. A 16^2 stand-in (the ``highres32`` preset with its 4^2 ROM refined
   twice and one decoder block, f64, the JAX model's Flax state carried
   across by ``convert.py``) with the budget patched on both sides so that S = 4
   runs as two chunks of 3 (S_eff 6), for y and for x, and the one-shot
   path with the budget left as it is.  Every draw is injected from one
   numpy stream per side in call order (the posterior samples, the
   property map's and the ROM's reparametrised draws, the x decodes'
   noise).  The JAX function runs under ``jax.disable_jit()``: there
   ``lax.map`` loops over the chunks in Python, so each chunk draws anew,
   as the port's chunks do.  Metrics, ``y_mean`` and ``y_std`` to 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import analysis as janalysis
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import components as jcomp
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.inference import (
    analysis as tanalysis)
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import (
    components as tcomp)

N, S, CHUNK = 4, 4, 3
STAND_IN = dict(num_refines=2, dec_blocks=(1,), dtype="float64")  # 16^2


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# (label width, validation fields, S) -> (chunk, n_chunks) of the JAX
# package: per grid node, then per free dof (the labels' real width)
TABLE = [(129 ** 2, 64, 16, (16, 1)), (129 ** 2, 64, 64, (64, 1)),
         (129 ** 2, 64, 128, (126, 2)), (257 ** 2, 32, 64, (63, 2)),
         (257 ** 2, 32, 128, (63, 3)), (513 ** 2, 32, 64, (15, 5)),
         (513 ** 2, 32, 128, (15, 9)),
         (4 ** 7 - 1, 64, 128, (128, 1)), (4 ** 8 - 1, 32, 64, (64, 1)),
         (4 ** 8 - 1, 32, 128, (64, 2)), (4 ** 9 - 1, 32, 64, (16, 4)),
         (4 ** 9 - 1, 32, 128, (16, 8))]


@pytest.mark.parametrize("width,n_val,n_mc,plan", TABLE)
def test_mc_chunk_matches_jax(width, n_val, n_mc, plan):
    per_mc = n_val * width
    got = tanalysis._mc_chunk(n_mc, per_mc)
    assert got == janalysis._mc_chunk(n_mc, per_mc)
    assert got == plan
    for budget in (1, per_mc - 1, 3 * per_mc, 10 ** 12):
        assert tanalysis._mc_chunk(n_mc, per_mc, budget) \
            == janalysis._mc_chunk(n_mc, per_mc, budget)


class _JaxRandom:
    def __init__(self, draw):
        self.draw = draw

    def normal(self, key, shape, dtype=jnp.float64):
        return jnp.asarray(self.draw(shape), dtype)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    def __init__(self, draw):
        self.random = _JaxRandom(draw)

    def __getattr__(self, name):
        return getattr(jax, name)


def _inject(monkeypatch, seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)

    def jn(shape):
        return jnp.asarray(rj.standard_normal(tuple(shape)))

    def tn(shape):
        return torch.as_tensor(rt.standard_normal(tuple(shape)))

    def j_sample_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jn((m.shape[0], n, m.shape[-1]))

    def t_sample_all(params, generator, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * tn((m.shape[0], n, m.shape[-1]))

    def j_gp(gp_out, key):
        if not isinstance(gp_out, tuple):
            return gp_out
        mean, logsigmas = gp_out
        return mean + jnp.exp(logsigmas) * jn(logsigmas.shape)

    def j_propagate(self, params, effprops, F, key):
        mean, logsigmas = self(params, effprops, F)
        return mean + jnp.exp(logsigmas) * jn(mean.shape)

    for mod, name, fn in (
            (jva, "sample_all_components", j_sample_all),
            (janalysis, "propagate_gp_samples", j_gp),
            (jcomp.ReducedOrderModelOperator, "propagate_samples",
             j_propagate),
            (janalysis, "jax", _Jax(lambda shape: rj.standard_normal(
                tuple(shape)))),
            (tva, "sample_all_components", t_sample_all),
            (tcomp, "standard_normal", lambda shape, like, g=None:
             tn(shape)),
            (tanalysis, "standard_normal", lambda shape, like, g=None:
             tn(shape))):
        monkeypatch.setattr(mod, name, fn)


@pytest.fixture(scope="module")
def setting():
    jphys, jm, _, _, _ = jmf.highres32(**STAND_IN).setup()
    rng = np.random.default_rng(0)
    X = rng.normal(0.4, 0.8, (N, 16, 16))
    params, bs = jm.init_params(jax.random.PRNGKey(0),
                                {"supervised": {"X": jnp.asarray(X)}},
                                (16, 16))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    params)
    bs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), bs)
    _, model, _, _, _ = highres32(**STAND_IN).setup(device="cpu")
    model.init_params({"supervised": {"X": np.zeros((N, 1))}})
    load_flax_variables(model, params, bs)
    data = {"X": X, "Y": rng.normal(0.0, 0.3, (N, jm.g.dim_out)),
            "F_ROM_BC": rng.normal(0.0, 1.0,
                                   (N, jphys["rom"].grid.n_nodes))}
    dz = params["q_z"]["supervised"]["mean"].shape[-1]
    q = {"mean": 0.3 * rng.normal(size=(N, dz)),
         "logsigma": -1.0 + 0.1 * rng.normal(size=(N, dz))}
    return jm, params, bs, model, data, q


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunks-of-3", "one-shot"])
@pytest.mark.parametrize("kind", ["y", "x"])
def test_streamed_analysis_matches_jax(setting, monkeypatch, kind, chunked):
    jm, params, bs, model, data, q = setting
    N_, dim = data["Y"].shape if kind == "y" else (
        N, int(np.prod(data["X"].shape[1:])))
    if chunked:
        budget = CHUNK * N_ * dim * (1 if kind == "y" else 8)
        monkeypatch.setattr(janalysis, "_EVAL_ELEMENT_BUDGET", budget)
        monkeypatch.setattr(tanalysis, "_EVAL_ELEMENT_BUDGET", budget)
    want_plan = (CHUNK, 2) if chunked else (S, 1)
    _inject(monkeypatch, 41)

    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    tq = {k: torch.as_tensor(v) for k, v in q.items()}
    ja = janalysis.Analysis(model=jm, data=jdata)
    ta = tanalysis.Analysis(model, tdata)
    with jax.disable_jit():
        if kind == "y":
            want = ja.eval_all_y_fn(S)(params, jq, jax.random.PRNGKey(0),
                                       jdata["Y"], jdata["F_ROM_BC"])
        else:
            want = ja.eval_all_x_fn(S)(params, bs, jq, jax.random.PRNGKey(0),
                                       jdata["X"])
    if kind == "y":
        y_mean, y_std = ta.eval_all_y(tq, None, S, iteration=0,
                                      return_mean_std=True)
        got = {k: ta.series[k].final() for k in ("relerr_y", "r2_y",
                                                 "logscore_y")}
        assert _rel(y_mean.numpy(), want["y_mean"]) <= 1e-10
        assert _rel(y_std.numpy(), want["y_std"]) <= 1e-10
        with pytest.raises(ValueError, match="iteration"):
            ta.eval_all_y(tq, None, S, return_mean_std=True)
    else:
        got = ta.eval_all_x(tq, None, S)
    for k, v in got.items():
        assert _rel(v, want[k]) <= 1e-10, k
    assert ta.mc_chunks == {(kind, S): want_plan}
