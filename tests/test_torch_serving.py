"""The port's surrogate (encoder, gp, g, DiscriminativeModel) and its
pad-to-bucket serving against the JAX package's highres32 model, whose
Flax weights carry over through ``convert.py``.  Eval mode, f64 to 1e-8,
f32 to 1e-4 (conv and matmul sums in another order).  The slice as a whole
is held here too: fields -> labels -> predictions."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import serving as jserving
from generative_physics_informed_pde_tpu.factories.model import (
    highres32 as j_highres32)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.convert import (
    discriminative_from_flax, load_flax_variables)
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.models import same_padding
from generative_physics_informed_pde_tpu_torch.serving import (
    DEFAULT_BUCKETS, SurrogateBundle)

LABELED = Path(__file__).resolve().parents[1] / "cdata" / \
    "highres32.labeled.npz"


def _perturb(tree, rng):
    """Random BatchNorm scales/biases/statistics and logsigmas, so that the
    comparison exercises them (a fresh init holds ones and zeros)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean") or k.startswith("logsigmas"):
            v = 0.1 * rng.normal(size=v.shape)
        out[k] = v.astype(np.float64)
    return out


def _as(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


@pytest.fixture(scope="module")
def models():
    physics, jmodel, jdm, _, _ = j_highres32().setup()
    X = jnp.zeros((4, 32, 32), dtype=jnp.float32)
    params, bs = jmodel.init_params(jax.random.PRNGKey(0),
                                    {"supervised": {"X": X}}, (32, 32))
    rng = np.random.default_rng(0)
    params = {k: _perturb(params[k], rng) for k in ("encoder", "gp", "g")}
    bs = {"encoder": _perturb(bs["encoder"], rng)}
    tphys, _, tdm32, _, dtype = highres32().setup(device="cpu")
    assert dtype == torch.float32
    discriminative_from_flax(tdm32, params, bs)  # rounds to f32
    tdm = highres32().setup(device="cpu")[2].double()
    discriminative_from_flax(tdm, params, bs)
    return physics, jmodel, jdm, params, bs, tphys, tdm, tdm32


def _request(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.4, 0.8, (n, 32, 32)).astype(dtype)
    F = rng.uniform(-0.5, 0.5, (n, 25)).astype(dtype)
    return x, F


def test_same_padding_is_flax_same():
    assert same_padding(32, 7, 2) == (2, 3)
    assert same_padding(16, 3, 2) == (0, 1)
    assert same_padding(8, 3, 1) == (1, 1)
    assert same_padding(8, 1, 1) == (0, 0)


def test_encoder_gp_g_match_f64(models):
    _, jmodel, _, params, bs, _, tdm, _ = models
    m = tdm.model
    x, F = _request(5, 1)
    (jm, jl), _ = jmodel.apply_encoder(params, bs, jnp.asarray(x),
                                       train=False)
    tm, tl = m.apply_encoder(torch.as_tensor(x))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-8, atol=1e-8)
    z = np.random.default_rng(2).normal(size=(5, 16))
    for a, b in zip(m.apply_gp(torch.as_tensor(z)),
                    jmodel.apply_gp(params, jnp.asarray(z))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-8, atol=1e-8)
    c = np.random.default_rng(3).normal(size=(5, 32))
    for a, b in zip(m.apply_g(torch.as_tensor(c), torch.as_tensor(F)),
                    jmodel.apply_g(params, jnp.asarray(c), jnp.asarray(F))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8),
                                       (np.float32, 1e-4)])
def test_discriminative_model_matches(models, dtype, tol):
    _, _, jdm, params, bs, _, tdm64, tdm32 = models
    x, F = _request(6, 4, dtype)
    expect = np.asarray(jdm(_as(params, dtype), _as(bs, dtype),
                            jnp.asarray(x), jnp.asarray(F)))
    m = tdm64 if dtype == np.float64 else tdm32
    got = m(torch.as_tensor(x), torch.as_tensor(F)).numpy()
    assert got.shape == (6, 1023) and got.dtype == dtype
    scale = np.abs(expect).max()
    np.testing.assert_allclose(got, expect, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def bundle(models):
    tdm = models[-2]
    return SurrogateBundle.build(tdm, (32, 32), 25, buckets=(4, 8),
                                 dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("n", [3, 4, 13, 16])
def test_predict_pads_and_streams(models, bundle, n):
    """n=3 pads to bucket 4; 13 streams as 8 + a padded 5; the padding is
    invisible in the result."""
    _, _, jdm, params, bs, _, _, _ = models
    x, F = _request(n, 10 + n)
    served = bundle.predict(x, F)
    assert served.shape == (n, 1023)
    expect = np.asarray(jdm(params, bs, jnp.asarray(x), jnp.asarray(F)))
    np.testing.assert_allclose(served.numpy(), expect, rtol=1e-8, atol=1e-8)


def test_predict_validates_and_casts(models, bundle):
    x, F = _request(4, 5)
    with pytest.raises(ValueError):
        bundle.predict(x, F[:2])
    with pytest.raises(ValueError, match="empty"):
        bundle.predict(x[:0], F[:0])
    with pytest.raises(ValueError, match="image shape"):
        bundle.predict(x[:, :-1], F)
    with pytest.raises(ValueError, match="feature dim"):
        bundle.predict(x, F[:, :-1])
    with pytest.raises(ValueError, match="scalar"):
        bundle.predict(np.float64(1.0), F)
    b32 = SurrogateBundle.build(models[-1], (32, 32), 25, device="cpu")
    assert b32.buckets == DEFAULT_BUCKETS == jserving.DEFAULT_BUCKETS
    y32 = b32.predict(torch.as_tensor(x, dtype=torch.float32),
                      torch.as_tensor(F, dtype=torch.float32))
    y64 = b32.predict(x, F)
    assert y32.dtype == torch.float32
    assert torch.equal(y32, y64)


def test_serving_snapshot_is_a_copy(models):
    """Changing the module after build does not change what is served."""
    tdm = models[-2]
    b = SurrogateBundle.build(tdm, (32, 32), 25, buckets=(4,),
                              dtype=torch.float64, device="cpu")
    x, F = _request(2, 6)
    before = b.predict(x, F)
    with torch.no_grad():
        tdm.model.gp.Dense_0.bias.add_(1.0)
    try:
        assert torch.equal(before, b.predict(x, F))
    finally:
        with torch.no_grad():
            tdm.model.gp.Dense_0.bias.sub_(1.0)


def test_convert_rejects_incomplete_or_misshapen_trees(models):
    _, _, _, params, bs, _, tdm, _ = models
    gp = {k: v for k, v in params["gp"].items() if k != "logsigmas_X"}
    with pytest.raises(KeyError, match="logsigmas_X"):
        load_flax_variables(tdm.model.gp, gp)
    bad = dict(params["gp"], logsigmas_X=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tdm.model.gp, bad)
    with pytest.raises(KeyError, match="no submodule"):
        load_flax_variables(tdm.model.gp, {"Dense_9": {"bias": np.zeros(1)}})
    discriminative_from_flax(tdm, params, bs)  # restore


def test_slice_fields_to_labels_to_predictions(models):
    """The highres32 slice on 8 fields of the labeled pool: the port's
    labels equal JAX's (f64, 1e-8) and its surrogate's predictions equal
    JAX's; so does the rel-L2 of the predictions against the labels."""
    jphys, _, jdm, params, bs, tphys, tdm, _ = models
    with np.load(LABELED) as data:
        X = data["X"][:8]
    bce = tfem.BoundaryConditionEnsemble.from_factory(
        "NDP", 8, np.random.default_rng(0))
    bce.register_function_space("fom", tphys["fom"].grid)
    bce.register_function_space("rom", tphys["rom"].grid)
    vals = bce.constrained_values("fom")
    F = np.array(bce.full_f_with_applied_bc("rom"))

    alphas = torch.exp(tphys["fom"].pixels.image_to_function(
        torch.as_tensor(X)))
    Y = tphys["fom"].solve_batched(alphas, torch.as_tensor(vals)).numpy()
    jalphas = jnp.exp(jphys["fom"].pixels.image_to_function(jnp.asarray(X)))
    Yj = np.asarray(jphys["fom"].solve_batched(jalphas, jnp.asarray(vals)))
    np.testing.assert_allclose(Y, Yj, rtol=1e-8, atol=1e-8)

    served = SurrogateBundle.build(tdm, (32, 32), 25, dtype=torch.float64,
                                   device="cpu").predict(X, F).numpy()
    expect = np.asarray(jdm(params, bs, jnp.asarray(X), jnp.asarray(F)))
    np.testing.assert_allclose(served, expect, rtol=1e-8, atol=1e-8)
    rel = np.linalg.norm(served - Y, axis=1) / np.linalg.norm(Y, axis=1)
    rel_j = np.linalg.norm(expect - Yj, axis=1) / np.linalg.norm(Yj, axis=1)
    assert np.all(np.isfinite(rel))
    np.testing.assert_allclose(rel, rel_j, rtol=1e-6)


@pytest.mark.parametrize("hidden,independent", [(0, False), (2, True)])
def test_effective_property_map_variants(hidden, independent):
    """gp with hidden layers (linearly decayed widths) and without the
    logsigmas head, weights carried over from Flax."""
    from generative_physics_informed_pde_tpu.models import (
        EffectivePropertyMap as JMap)
    from generative_physics_informed_pde_tpu_torch.models import (
        EffectivePropertyMap as TMap)

    jmap = JMap(latent_dim=16, dim_effective_property=32,
                num_hidden_layers=hidden, independent_X=independent)
    z = np.random.default_rng(7).normal(size=(5, 16))
    params = _as(jmap.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"],
                 np.float64)
    tmap = TMap(16, 32, num_hidden_layers=hidden,
                independent_X=independent).double()
    load_flax_variables(tmap, params)
    expect = jmap.apply({"params": params}, jnp.asarray(z))
    got = tmap(torch.as_tensor(z))
    if not independent:
        expect, got = (expect,), (got,)
    assert len(got) == len(expect)
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-8, atol=1e-8)
