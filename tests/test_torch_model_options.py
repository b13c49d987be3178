"""The model options of the port against the JAX package's
(``tests/test_models.py`` and ``tests/test_model_variants.py``): the
``highres128`` presets and the factory knobs, ``n_mc > 1``, the
non-amortized unlabeled term, fused decodes, ``remat_codec``, the
reduced-precision codec and its scope in the unlabeled terms, bilinear
upsampling, channel padding through ``convert.py``, and the linear and MLP
codecs.

The ELBO checks run a ``highres128`` stand-in (``nx_rom=ny_rom=4,
num_refines=3``: a 32^2 target, two up-sampling blocks) in f64 from the JAX model's
perturbed state.  Draws are injected into both packages: each shape has its
own numpy stream, so that two packages that make the same draws in another
order across shapes still see the same numbers; the JAX side hands out one
draw per posterior (the traced ``mean`` it is drawn around) and shape,
because the JAX fused path redraws a term's z-samples from the key it
already drew them from.

Tolerances: f64 ELBO, logs, gradients and BatchNorm statistics 1e-8
(convolution sums in another order); linear and MLP codecs and the
channel-padded codecs 1e-12; bf16 against JAX's bf16 1e-2 of the output
scale (measured: bit-equal in eval mode, 1.3e-3 in train mode, where the
f32 batch statistics are summed in another order and flip bf16 roundings);
bf16 against full precision the JAX test's 0.05 of the scale; the bf16
unlabeled term's likelihood and KLD against JAX's bf16 term 0.05 relative
(measured 1.8e-2: the encoder's bf16 roundings reach the decoder's
logsigma, and the term sums 32^2 pixel log-likelihoods per field).  The
bilinear upsampling is exact align_corners sampling in the port (1e-12
against numpy); the JAX package computes its sampling coordinates in f32
even for f64 data, so the two agree to the f32 rounding of those
coordinates, 1e-6 of the scale (measured 3.3e-7).
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.factories import data as jdf
from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import (
    CNNDecoder as JDecoder, CNNEncoder as JEncoder,
    LinearDecoder as JLinearDecoder, LinearEncoder as JLinearEncoder,
    NeuralNetworkDecoder as JNNDecoder, NeuralNetworkEncoder as JNNEncoder)
from generative_physics_informed_pde_tpu.models import generative as jgen
from generative_physics_informed_pde_tpu.models.codec import (
    upsample_bilinear_2x as j_bilinear)
from generative_physics_informed_pde_tpu.models.mlp import (
    FeedforwardNeuralNetwork as JMLP)
from generative_physics_informed_pde_tpu.training.trainer import (
    resolve_pe_compute_dtype as j_resolve_pe)
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.factories import data as tdf
from generative_physics_informed_pde_tpu_torch.factories import model as tmf
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.inference.prediction import (
    PredictionEnsemble)
from generative_physics_informed_pde_tpu_torch.models import (
    CNNDecoder, CNNEncoder, FeedforwardNeuralNetwork, LinearDecoder,
    LinearEncoder, NeuralNetworkDecoder, NeuralNetworkEncoder,
    upsample_bilinear_2x)
from generative_physics_informed_pde_tpu_torch.models import generative as tgen
from generative_physics_informed_pde_tpu_torch.training import (
    resolve_pe_compute_dtype)

NS, NU, NV = 3, 5, 2
STAND_IN = dict(nx_rom=4, ny_rom=4, num_refines=3)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(tree, dtype=np.float64):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


class Draws:
    """Standard normals from one numpy stream per shape."""

    def __init__(self, seed):
        self.seed, self.rngs = seed, {}

    def normal(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self.rngs:
            self.rngs[shape] = np.random.default_rng([self.seed, *shape])
        return self.rngs[shape].standard_normal(shape)


def _inject(monkeypatch, seed):
    """Per-shape draws for both packages; on the JAX side one draw per
    (posterior, shape) within one trace (``memo`` keeps the traced means
    alive, so their ids are not reused)."""
    dj, dt = Draws(seed), Draws(seed)
    memo = {}

    def jn(around, shape):
        k = (id(around), tuple(shape))
        if k not in memo:
            memo[k] = (around, jnp.asarray(dj.normal(shape)))
        return memo[k][1]

    def tn(shape, like):
        return torch.as_tensor(dt.normal(shape), dtype=like.dtype)

    def j_sample(params, key):
        ls = params["logsigma"]
        return params["mean"] + jnp.exp(ls) * jn(
            params["mean"], ls.shape).astype(ls.dtype)

    def j_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        shape = (m.shape[0], n, m.shape[-1])
        return m + jnp.exp(ls) * jn(params["mean"], shape).astype(ls.dtype)

    def j_rep(key, mean, logsigma):
        return mean + jnp.exp(logsigma) * jn(mean, logsigma.shape).astype(
            logsigma.dtype)

    def t_sample(params, generator=None):
        ls = params["logsigma"]
        return params["mean"] + torch.exp(ls) * tn(ls.shape, ls)

    def t_all(params, generator, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * tn((m.shape[0], n, m.shape[-1]), ls)

    def t_rep(generator, mean, logsigma):
        return mean + torch.exp(logsigma) * tn(logsigma.shape, logsigma)

    for mod, name, fn in ((jva, "sample", j_sample),
                          (jva, "sample_all_components", j_all),
                          (jgen, "reparametrize", j_rep),
                          (tva, "sample", t_sample),
                          (tva, "sample_all_components", t_all),
                          (tgen, "reparametrize", t_rep)):
        monkeypatch.setattr(mod, name, fn)


def _perturb(tree, rng):
    """Random BatchNorm statistics and scales, posteriors and logsigmas
    (a fresh init holds ones and zeros)."""
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


@pytest.fixture(scope="module")
def stand_in():
    """The JAX stand-in model, data and its perturbed f64 state."""
    jphys, jm, _, _, _ = jmf.highres128(dtype="float64", **STAND_IN).setup()
    rng = np.random.default_rng(0)
    n_f = jm.g.dim_out
    F = rng.normal(0.0, 1.0, (NS + NV, jphys["rom"].grid.n_nodes))
    data = {"X_s": rng.normal(0.4, 0.8, (NS, 32, 32)),
            "Y_s": rng.normal(0.0, 0.3, (NS, n_f)),
            "X_u": rng.normal(0.4, 0.8, (NU, 32, 32)),
            "X_v": rng.normal(0.4, 0.8, (NV, 32, 32)),
            "vo_mean": rng.normal(0.0, 0.3, (NV, n_f)),
            "vo_logsigma": np.full((NV, n_f), -1.0),
            "F_s": F[:NS], "F_v": F[NS:]}
    params, bs = jm.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(data["X_s"])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])},
         "vo": {"X": jnp.asarray(data["X_v"])}}, (32, 32))
    prng = np.random.default_rng(2)
    return jm, _perturb(_np(params), prng), _perturb(_np(bs), prng), data


def _port(jm, params, bs, data, **margs):
    """The port's stand-in with the JAX state loaded (the same posteriors:
    'unsupervised' only without the encoder)."""
    _, model, _, _, _ = tmf.highres128(dtype="float64", **STAND_IN,
                                       **margs).setup(device="cpu")
    if "encoder" not in params:
        model.encoder = None
    sets = {"supervised": {"X": data["X_s"]},
            "unsupervised": {"X": data["X_u"]}, "vo": {"X": data["X_v"]}}
    model.init_params(sets)
    return load_flax_variables(model, params, bs)


def _jdata(data, vo=True):
    d = {"supervised": {"X": jnp.asarray(data["X_s"]),
                        "Y": jnp.asarray(data["Y_s"]),
                        "F_ROM_BC": jnp.asarray(data["F_s"])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])}}
    if vo:
        d["vo"] = {"X": jnp.asarray(data["X_v"]),
                   "F_ROM_BC": jnp.asarray(data["F_v"])}
    return d


def _tdata(data, vo=True, dtype=torch.float64):
    return jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.asarray(a), dtype=dtype),
        _jdata(data, vo))


def _vo_state(data, framework):
    if framework == "jax":
        return (jnp.asarray(data["vo_mean"]),
                jnp.asarray(data["vo_logsigma"]))
    return (torch.as_tensor(data["vo_mean"]),
            torch.as_tensor(data["vo_logsigma"]))


def _grads(model, jgrads, bs):
    g = copy.deepcopy(model)
    load_flax_variables(g, _np(jgrads), bs)
    return dict(g.named_parameters())


def _stats(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _check_against_jax(jm, params, bs, data, model, *, vo=True,
                       holdoff=False, rtol=1e-8):
    """One train-mode ELBO with its gradients and BatchNorm statistics,
    both packages (the injection must be in place)."""
    jd = _jdata(data, vo)
    vo_state = _vo_state(data, "jax") if vo else None

    def loss(p):
        e, new_bs, logs = jm.elbo(p, bs, jd, jax.random.PRNGKey(3),
                                  vo_state=vo_state, vo_holdoff=holdoff)
        return e, (new_bs, logs)

    (ej, (bs_j, logs_j)), gj = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    et, logs_t = model.elbo(_tdata(data, vo), None,
                            vo_state=_vo_state(data, "torch") if vo
                            else None, vo_holdoff=holdoff)
    et.backward()
    assert _rel(et.detach().numpy(), ej) <= rtol
    for k, v in logs_j.items():
        got = logs_t[k]
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        assert _rel(got, v) <= rtol, k
    want = _grads(model, gj, bs)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel(g.numpy(), want[name].detach().numpy()) <= rtol, name
    ref = copy.deepcopy(model)
    load_flax_variables(ref, params, _np(bs_j))
    want = _stats(ref)
    for name, b in _stats(model).items():
        assert _rel(b.numpy(), want[name].numpy()) <= rtol, name
    return logs_t


# ------------------------------------------------------------ the presets
def _count(tree):
    return sum(int(np.prod(np.shape(x)))
               for x in jax.tree_util.tree_leaves(tree))


def test_highres128_presets_match_jax():
    jphys, jm, _, jenc, _ = jmf.ModelFactory.FromIdentifier(
        "highres128").setup()
    tphys, tm, _, tenc, tdt = tmf.ModelFactory.FromIdentifier(
        "highres128").setup(device="cpu")
    assert tdt == torch.float32 and tenc is tm.encoder
    for key in ("fom", "rom"):
        assert (tphys[key].grid.nx, tphys[key].grid.ny) == \
            (jphys[key].grid.nx, jphys[key].grid.ny)
        assert tphys[key].physics_id == jphys[key].physics_id == "NDP"
    assert tphys["fom"].grid.nx == 128 and tphys["rom"].grid.nx == 8
    assert tm.f.blocks == tuple(jm.f.blocks) == (1, 2, 1, 1)
    assert tm.encoder.blocks == tuple(jenc.blocks) == (1, 2, 1)
    assert tm.f.latent_img_features == jm.f.latent_img_features == 2
    assert tm.unsup_compute_dtype == torch.bfloat16
    assert jm.unsup_compute_dtype == jnp.bfloat16
    f_vars = jax.jit(lambda k, z: jm.f.init(k, z, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64)))
    e_vars = jax.jit(lambda k, x: jenc.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 128, 128)))
    for module, v in ((tm.f, f_vars), (tm.encoder, e_vars)):
        assert sum(p.numel() for p in module.parameters()) \
            == _count(v["params"])
        # every leaf of the Flax tree loads, shape for shape
        load_flax_variables(module, _np(v["params"], np.float32),
                            _np(v["batch_stats"], np.float32))
    z = torch.zeros(1, 64)
    mean, logsigma = tm.apply_decoder(z, train=False)
    assert mean.shape == logsigma.shape == (1, 128, 128)
    # the stand-in: 32^2, two up-sampling blocks, no bf16 below 128^2
    _, m32, _, e32, _ = tmf.highres128(**STAND_IN).setup(device="cpu")
    _, jm32, _, je32, _ = jmf.highres128(**STAND_IN).setup()
    assert m32.f.blocks == tuple(jm32.f.blocks) == (1, 2)
    assert e32.blocks == tuple(je32.blocks) == (1, 2)
    assert m32.unsup_compute_dtype is None and jm32.unsup_compute_dtype \
        is None
    # the data preset
    jd, td = jdf.DataFactory.FromIdentifier("highres128"), \
        tdf.DataFactory.FromIdentifier("highres128")
    assert (td._N, td._N_unsupervised) == (jd._N, jd._N_unsupervised) \
        == (2048, 20480)
    for a in ("mean", "stddev", "corrlength", "py", "px", "method"):
        assert getattr(td._rfs, a) == getattr(jd._rfs, a), a


def test_fetch_dtype_and_pe_dtype_resolution():
    for name in ("bfloat16", "bf16", "float32", "float64", "double"):
        assert str(tmf.fetch_dtype(name)).split(".")[-1] \
            == jnp.dtype(jmf.fetch_dtype(name)).name
    for shape in ((4, 32, 32), (4, 64, 64), (4, 128, 128), (2, 256, 128)):
        for value in ("auto", None, "bfloat16", "float32"):
            j = j_resolve_pe(value, shape)
            t = resolve_pe_compute_dtype(value, shape)
            assert (t is None) == (j is None), (shape, value)
            if t is not None:
                assert str(t).split(".")[-1] == jnp.dtype(j).name
    with pytest.raises(ValueError):
        tmf.fetch_dtype("float16")


def test_dec_architecture_overrides():
    mf = tmf.ModelFactory.FromIdentifier("highres128")
    mf.set({"dec_growth_rate": 12, "dec_init_features": 12,
            "dec_blocks": (1, 1, 1, 1)})
    _, model, *_ = mf.setup(device="cpu")
    jf = jmf.ModelFactory.FromIdentifier("highres128")
    jf.set({"dec_growth_rate": 12, "dec_init_features": 12,
            "dec_blocks": (1, 1, 1, 1)})
    _, jm, *_ = jf.setup()
    assert model.f.blocks == (1, 1, 1, 1)
    assert model.f.growth_rate == 12 and model.f.init_features == 12
    v = jax.jit(lambda k, z: jm.f.init(k, z, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64)))
    assert sum(p.numel() for p in model.f.parameters()) \
        == _count(v["params"])
    mean, logsigma = model.apply_decoder(torch.randn(2, 64), train=False)
    assert mean.shape == logsigma.shape == (2, 128, 128)
    assert bool(torch.isfinite(mean).all())
    bad = tmf.ModelFactory.FromIdentifier("highres128")
    bad.set({"dec_blocks": (1, 1)})
    with pytest.raises(ValueError, match="4 entries"):
        bad.setup(device="cpu")
    # a falsy override is not the preset value: it reaches the decoder
    zero = tmf.ModelFactory.FromIdentifier("highres32", dec_blocks=())
    with pytest.raises(ValueError):
        zero.setup(device="cpu")


@pytest.mark.parametrize("ident", ["highres", "highres32"])
def test_decode_knobs_consumed_by_every_preset(ident):
    mf = tmf.ModelFactory.FromIdentifier(
        ident, codec_pad_cin=8, dec_growth_rate=6, dec_init_features=10,
        fuse_decodes=True, remat_codec=True, compute_dtype="bfloat16",
        unsup_compute_dtype=None)
    _, model, _, encoder, _ = mf.setup(device="cpu")
    assert model.f.pad_cin == 8 and encoder.pad_cin == 8
    assert model.f.growth_rate == 6 and model.f.init_features == 10
    assert model.fuse_decodes and model.remat_codec
    assert model.unsup_compute_dtype is None
    assert model.f.compute_dtype == encoder.compute_dtype == torch.bfloat16
    assert next(model.f.parameters()).dtype == torch.float32
    for ident2 in ("highres", "highres32", "highres128"):
        _, m, *_ = tmf.ModelFactory.FromIdentifier(
            ident2, homoscedastic=True).setup(device="cpu")
        assert m.f.homoscedastic, ident2
        _, m2, *_ = tmf.ModelFactory.FromIdentifier(
            ident2, binary_field=True).setup(device="cpu")
        assert m2.f.binary, ident2


# ---------------------------------------------------------- ELBO options
def test_elbo_with_four_mc_samples_matches_jax(stand_in, monkeypatch):
    jm, params, bs, data = stand_in
    jm4 = dataclasses.replace(jm, n_mc=4)
    model = _port(jm, params, bs, data)
    model.n_mc = 4
    _inject(monkeypatch, 11)
    logs = _check_against_jax(jm4, params, bs, data, model, vo=False)
    assert {"supervised_logL_x", "ARM_unsupervised_logL_x"} <= set(logs)


def test_non_amortized_elbo_matches_jax(stand_in, monkeypatch):
    jm, params, bs, data = stand_in
    jm0 = dataclasses.replace(jm, encoder=None)
    p0, _ = jm0.init_params(
        jax.random.PRNGKey(0),
        {"supervised": {"X": jnp.asarray(data["X_s"])},
         "unsupervised": {"X": jnp.asarray(data["X_u"])},
         "vo": {"X": jnp.asarray(data["X_v"])}}, (32, 32))
    p0 = dict(params, q_z=dict(params["q_z"], unsupervised=_perturb(
        _np(p0["q_z"]["unsupervised"]), np.random.default_rng(5))))
    p0.pop("encoder")
    b0 = {"f": bs["f"]}
    model = _port(jm0, p0, b0, data)
    assert model.encoder is None and "unsupervised" in model.q_z
    _inject(monkeypatch, 12)
    logs = _check_against_jax(jm0, p0, b0, data, model, vo=False)
    assert "unsupervised_DKL_z" in logs
    # its KLD is the unlabeled posterior's, not the labeled one's
    assert _rel(logs["unsupervised_DKL_z"].detach().numpy(),
                tva.kld(model.q_z["unsupervised"]).detach().numpy()) == 0


@pytest.mark.parametrize("holdoff", [False, True])
def test_fused_decode_matches_unfused_in_eval_bit_for_bit(stand_in, holdoff):
    jm, params, bs, data = stand_in
    logs = {}
    for fuse in (False, True):
        model = _port(jm, params, bs, data)
        model.n_mc = 2
        model.fuse_decodes = fuse
        gen = torch.Generator().manual_seed(4)
        _, logs[fuse] = model.elbo(_tdata(data), gen, train=False,
                                   vo_state=_vo_state(data, "torch"),
                                   vo_holdoff=holdoff)
        logs[fuse]["generator"] = gen.get_state()
    assert set(logs[True]) == set(logs[False])
    for k, v in logs[False].items():
        assert torch.equal(torch.as_tensor(logs[True][k]),
                           torch.as_tensor(v)), k


def test_fused_decode_in_train_mode_matches_jax(stand_in, monkeypatch):
    jm, params, bs, data = stand_in
    jf = dataclasses.replace(jm, fuse_decodes=True, n_mc=2)
    model = _port(jm, params, bs, data)
    model.fuse_decodes, model.n_mc = True, 2
    _inject(monkeypatch, 13)
    _check_against_jax(jf, params, bs, data, model, vo=True)


def test_fused_decode_with_one_term_keeps_unfused_semantics(stand_in):
    jm, params, bs, data = stand_in
    out = {}
    for fuse in (False, True):
        model = _port(jm, params, bs, data)
        model.fuse_decodes = fuse
        gen = torch.Generator().manual_seed(9)
        d = _tdata(data, vo=False)
        del d["unsupervised"]
        e, _ = model.elbo(d, gen, train=True)
        e.backward()
        out[fuse] = (e.detach(), gen.get_state(),
                     [p.grad for p in model.f.parameters()],
                     list(_stats(model).values()))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for a, b in zip(out[True][2] + out[True][3],
                    out[False][2] + out[False][3]):
        assert torch.equal(a, b)


def test_remat_codec_is_the_same_math(stand_in):
    """Values, gradients, BatchNorm statistics and the generator's state
    bit for bit, with channel dropout drawing masks from the generator."""
    jm, params, bs, data = stand_in
    out = {}
    for remat in (False, True):
        _, model, _, _, _ = tmf.highres128(
            dtype="float64", droprate=0.2, remat_codec=remat,
            **STAND_IN).setup(device="cpu")
        model.init_params({"supervised": {"X": data["X_s"]},
                           "vo": {"X": data["X_v"]}})
        load_flax_variables(model, params, bs)
        gen = torch.Generator().manual_seed(7)
        e, logs = model.elbo(_tdata(data), gen, train=True,
                             vo_state=_vo_state(data, "torch"))
        e.backward()
        out[remat] = (e.detach(), gen.get_state(),
                      {n: p.grad for n, p in model.named_parameters()},
                      _stats(model))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for n, g in out[False][2].items():
        assert torch.equal(out[True][2][n], g), n
    for n, b in out[False][3].items():
        assert torch.equal(out[True][3][n], b), n


def _f32_models(jm, params, bs, data):
    """The f32 stand-in in both packages: plain and with the unlabeled
    terms in bf16."""
    p32, b32 = _np(params, np.float32), _np(bs, np.float32)
    jplain = dataclasses.replace(jm, dtype=jnp.float32)
    jmixed = dataclasses.replace(jplain, unsup_compute_dtype=jnp.bfloat16)
    models = {}
    for ucd in (None, "bfloat16"):
        _, m, _, _, _ = tmf.highres128(unsup_compute_dtype=ucd,
                                       **STAND_IN).setup(device="cpu")
        m.init_params({"supervised": {"X": data["X_s"]},
                       "vo": {"X": data["X_v"]}})
        models[ucd] = load_flax_variables(m, p32, b32)
    return jplain, jmixed, p32, b32, models


def test_unsup_compute_dtype_is_scoped_to_the_unlabeled_term(stand_in):
    jm, params, bs, data = stand_in
    _, _, _, _, models = _f32_models(jm, params, bs, data)
    d = _tdata(data, dtype=torch.float32)
    out = {}
    for ucd, m in models.items():
        m0 = copy.deepcopy(m)
        e_sup, _ = m0.elbo_supervised(d["supervised"],
                                      torch.Generator().manual_seed(1))
        m1 = copy.deepcopy(m)
        e_u, _ = m1.elbo_unsupervised_amortized(
            d["unsupervised"]["X"], torch.Generator().manual_seed(2))
        m2 = copy.deepcopy(m)
        e_ev, _ = m2.elbo_unsupervised_amortized(
            d["unsupervised"]["X"], torch.Generator().manual_seed(2),
            train=False)
        out[ucd] = (e_sup.detach(), e_u.detach(), e_ev.detach())
    plain, mixed = out[None], out["bfloat16"]
    assert torch.equal(plain[0], mixed[0])   # supervised: untouched
    assert torch.equal(plain[2], mixed[2])   # eval mode: untouched
    assert float(plain[1]) != float(mixed[1])
    np.testing.assert_allclose(float(mixed[1]), float(plain[1]), rtol=0.2)
    # a train step of the mixed model: finite f32 gradients
    m = models["bfloat16"]
    e, _ = m.elbo(d, torch.Generator().manual_seed(3))
    e.backward()
    assert all(p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all()))
               for p in m.parameters())


def test_unsup_bf16_term_matches_jax_bf16(stand_in, monkeypatch):
    jm, params, bs, data = stand_in
    jplain, jmixed, p32, b32, models = _f32_models(jm, params, bs, data)
    _inject(monkeypatch, 14)
    Xu = data["X_u"].astype(np.float32)
    _, _, lj = jax.jit(lambda p, b, x: jmixed.elbo_unsupervised_amortized(
        p, b, x, jax.random.PRNGKey(5), train=True))(p32, b32, Xu)
    et, lt = models["bfloat16"].elbo_unsupervised_amortized(
        torch.as_tensor(Xu), None, train=True)
    for k in ("ARM_unsupervised_logL_x", "ARM_unsupervised_DKL_z"):
        assert _rel(lt[k].detach().numpy(), lj[k]) <= 0.05, k


def test_codec_bfloat16_matches_flax_bfloat16():
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 16)),
                   np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 32, 32)),
                   np.float32)
    outs = {}
    for cd in (None, "bfloat16"):
        _, jm, _, jenc, _ = jmf.ModelFactory.FromIdentifier(
            "highres32", compute_dtype=cd).setup()
        _, tm, _, tenc, _ = tmf.ModelFactory.FromIdentifier(
            "highres32", compute_dtype=cd).setup(device="cpu")
        fv = jm.f.init(jax.random.PRNGKey(1), jnp.asarray(z), train=False)
        ev = jenc.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
        load_flax_variables(tm.f, fv["params"], fv["batch_stats"])
        load_flax_variables(tenc, ev["params"], ev["batch_stats"])
        for train in (False, True):
            if train:
                (mj, lj), _ = jm.f.apply(fv, jnp.asarray(z), train=True,
                                         mutable=["batch_stats"])
                (ej, _), _ = jenc.apply(ev, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
            else:
                mj, lj = jm.f.apply(fv, jnp.asarray(z), train=False)
                ej, _ = jenc.apply(ev, jnp.asarray(x), train=False)
            mt, lt = tm.apply_decoder(torch.as_tensor(z), train=train)
            et, _ = tm.apply_encoder(torch.as_tensor(x), train=train)
            assert mt.dtype == lt.dtype == et.dtype == torch.float32
            outs[cd, train] = [t.detach().numpy() for t in (mt, lt, et)]
            tol = 1e-2 if cd else 1e-5
            for got, want in zip(outs[cd, train], (mj, lj, ej)):
                want = np.asarray(want, np.float32)
                assert np.abs(got - want).max() \
                    <= tol * np.abs(want).max(), (cd, train)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
    for train in (False, True):
        for a, b in zip(outs["bfloat16", train], outs[None, train]):
            assert np.abs(a - b).max() < 0.05 * np.abs(b).max()


# ----------------------------------------------- upsampling and padding
def test_bilinear_upsampling_is_align_corners_and_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in ((8, 8), (5, 7), (1, 4)):
        x = rng.standard_normal((2, 3, h, w))
        got = upsample_bilinear_2x(torch.as_tensor(x)).numpy()
        # numpy align_corners: output i samples input i (n-1) / (2n-1)
        want = x
        for axis, n in ((2, h), (3, w)):
            c = np.arange(2 * n) * ((n - 1) / max(2 * n - 1, 1))
            lo = np.floor(c).astype(int)
            hi = np.minimum(lo + 1, n - 1)
            shape = [1, 1, 1, 1]
            shape[axis] = 2 * n
            wgt = (c - lo).reshape(shape)
            want = np.take(want, lo, axis) * (1 - wgt) \
                + np.take(want, hi, axis) * wgt
        assert _rel(got, want) <= 1e-12, (h, w)
        ref = torch.nn.UpsamplingBilinear2d(scale_factor=2)(
            torch.as_tensor(x)).numpy()
        assert _rel(got, ref) <= 1e-12
        j = np.asarray(j_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1))))
        assert _rel(got, j.transpose(0, 3, 1, 2)) <= 1e-6, (h, w)


def test_bilinear_decoder_matches_flax():
    kw = dict(target_img_size=32, dim_latent=8, latent_img_size=8,
              latent_img_features=1, init_features=4, blocks=(1, 1),
              growth_rate=4)
    jd = JDecoder(upsample="bilinear", **kw)
    z = np.random.default_rng(1).normal(size=(5, 8))
    v = _np(jd.init(jax.random.PRNGKey(1), jnp.asarray(z), train=False))
    td = load_flax_variables(CNNDecoder(upsample="bilinear", **kw).double(),
                             v["params"], v["batch_stats"]).eval()
    mj, lj = jd.apply(v, jnp.asarray(z), train=False)
    mt, lt = td(torch.as_tensor(z))
    assert _rel(mt.detach().numpy(), mj) <= 1e-5
    assert _rel(lt.detach().numpy(), lj) <= 1e-5
    with pytest.raises(ValueError):
        CNNDecoder(upsample="bicubic", **kw)


@pytest.mark.parametrize("train", [False, True])
def test_pad_cin_flax_tree_converts_to_the_same_function(train):
    kw = dict(target_img_size=32, dim_latent=8, latent_img_size=8,
              latent_img_features=1, init_features=4, blocks=(1, 1),
              growth_rate=4)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(5, 8))
    x = rng.normal(size=(5, 32, 32))
    jd, je = JDecoder(pad_cin=8, **kw), JEncoder(
        imsize=32, latent_dim=8, blocks=(1, 1), growth_rate=4,
        init_features=4, pad_cin=8)
    dv = _np(jd.init(jax.random.PRNGKey(1), jnp.asarray(z), train=False))
    ev = _np(je.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    padded = [k.shape for k in jax.tree_util.tree_leaves(dv["params"])
              if k.ndim == 4 and k.shape[2] % 8 == 0]
    assert padded  # convs whose input rows were padded
    td = load_flax_variables(CNNDecoder(pad_cin=8, **kw).double(),
                             dv["params"], dv["batch_stats"])
    te = load_flax_variables(CNNEncoder(32, 8, blocks=(1, 1), growth_rate=4,
                                        init_features=4, pad_cin=8).double(),
                             ev["params"], ev["batch_stats"])
    td.train(train), te.train(train)
    if train:
        (mj, lj), _ = jd.apply(dv, jnp.asarray(z), train=True,
                               mutable=["batch_stats"])
        (ej, sj), _ = je.apply(ev, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        mj, lj = jd.apply(dv, jnp.asarray(z), train=False)
        ej, sj = je.apply(ev, jnp.asarray(x), train=False)
    mt, lt = td(torch.as_tensor(z))
    et, st = te(torch.as_tensor(x))
    for got, want in ((mt, mj), (lt, lj), (et, ej), (st, sj)):
        assert _rel(got.detach().numpy(), want) <= 1e-12


# ------------------------------------------------- linear and MLP codecs
def test_linear_and_mlp_codecs_match_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8))
    z = rng.normal(size=(3, 4))
    cases = [
        (JLinearEncoder(dim_in=64, latent_dim=4), LinearEncoder(64, 4), x),
        (JNNEncoder(dim_in=64, latent_dim=4, num_hidden_layers=2),
         NeuralNetworkEncoder(64, 4, num_hidden_layers=2), x),
        (JLinearEncoder(dim_in=64, latent_dim=4, binary=True),
         LinearEncoder(64, 4, binary=True), x),
        (JLinearDecoder(dim_latent=4, dim_out=64), LinearDecoder(4, 64), z),
        (JNNDecoder(dim_latent=4, dim_out=64, num_hidden_layers=1),
         NeuralNetworkDecoder(4, 64, num_hidden_layers=1), z),
        (JNNDecoder(dim_latent=4, dim_out=64, num_hidden_layers=3,
                    binary=True),
         NeuralNetworkDecoder(4, 64, num_hidden_layers=3, binary=True), z),
        (JMLP.from_linear_decay(4, 10, 2, out_activation=jnp.tanh,
                                dropout=0.3),
         FeedforwardNeuralNetwork.from_linear_decay(
             4, 10, 2, out_activation=torch.tanh, dropout=0.3), z),
    ]
    for jmod, tmod, inp in cases:
        v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(inp))
        v = _perturb(_np(v), np.random.default_rng(4))
        load_flax_variables(tmod.double(), v["params"])
        tmod.eval()
        want = jmod.apply(v, jnp.asarray(inp))
        got = tmod(torch.as_tensor(inp))
        for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (got, want))):
            assert g.shape == w.shape
            assert _rel(g.detach().numpy(), w) <= 1e-12, type(tmod)


def test_mlp_dropout_masks_come_from_the_generator():
    net = FeedforwardNeuralNetwork(6, 3, architecture=(5,), dropout=0.5)
    net.train()
    x = torch.randn(4, 6)
    a = net(x, torch.Generator().manual_seed(0))
    b = net(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        net(x)  # an active dropout needs the caller's generator


# ------------------------------------------------ prediction ensemble
def test_prediction_ensemble_decode_dtype():
    """The hot loop decodes in its compute dtype, the final updates and
    a decoder without a compute dtype at full precision."""
    _, model, _, _, _ = tmf.highres128(**STAND_IN).setup(device="cpu")
    X = torch.randn(3, 32, 32)
    pe = PredictionEnsemble(model, X, lambda n: 1e-2,
                            compute_dtype=torch.bfloat16)
    assert pe._decode_dtype(final=False) == torch.bfloat16
    assert pe._decode_dtype(final=True) is None
    q = {k: v.detach() for k, v in pe.q.items()}
    e_bf, _ = pe.elbo(q, torch.Generator().manual_seed(0))
    e_fin, _ = pe.elbo(q, torch.Generator().manual_seed(0), final=True)
    plain = PredictionEnsemble(model, X, lambda n: 1e-2)
    e_32, _ = plain.elbo(q, torch.Generator().manual_seed(0))
    assert torch.equal(e_fin, e_32) and not torch.equal(e_bf, e_32)
    np.testing.assert_allclose(float(e_bf), float(e_32), rtol=0.2)
    model.f = LinearDecoder(64, 32 * 32)
    assert pe._decode_dtype(final=False) is None


# ----------------------------------------------------------- ROM solve
def test_rom_solve_gives_nan_where_the_factorisation_fails_as_jax():
    """A ROM system that is not positive definite (an infinite or a
    negative conductivity) gives NaN in both packages, the port's
    ``cholesky_ex`` instead of raising; the other systems agree (f32,
    1e-6 of the scale)."""
    from generative_physics_informed_pde_tpu.fem.solvers import (
        rom_solve as j_rom_solve)
    from generative_physics_informed_pde_tpu_torch.fem.solvers import (
        rom_solve)

    _, model, *_ = tmf.highres32().setup(device="cpu")
    M, bc = model.g.rom.M.numpy(), model.g.rom.bc_dofs
    rng = np.random.default_rng(0)
    a = np.exp(rng.normal(size=(4, M.shape[-1]))).astype(np.float32)
    a[1, 3] = np.inf
    a[2] = -1.0
    F = rng.normal(size=(4, M.shape[0])).astype(np.float32)
    j = np.asarray(j_rom_solve(jnp.asarray(M, jnp.float32), jnp.asarray(a),
                               jnp.asarray(F), bc))
    t = rom_solve(torch.as_tensor(M, dtype=torch.float32),
                  torch.as_tensor(a), torch.as_tensor(F), bc).numpy()
    ok = np.isfinite(t).all(-1)
    assert ok.tolist() == np.isfinite(j).all(-1).tolist() \
        == [True, False, False, True]
    assert _rel(t[ok], j[ok]) <= 1e-6
