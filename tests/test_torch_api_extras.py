"""The rest of the port's public API against the JAX package's.

Boundary-condition encodings, the random field's numpy side, the ROM's
dense stiffness, the samplers, ``DataSet.get(random_subset=)``, the data
presets' dataset cache (a cache written by either package is a hit for
the other), ``DenseED`` against Flax (weights carried by ``convert.py``),
``Analysis.from_encoder`` / ``eval_all`` / ``sample_predictive_x`` under
injected draws, the parameter utilities with a frozen block under Adam,
the sparse conversions, the plots and the trainer's accessors.  Inputs are
seeded numpy, f64.

Tolerances: the covariance 1e-14, the KL subspace 1e-12 and the numpy
samples equal (the same numpy calls), the stiffness 1e-13, ``DenseED``
1e-10 in eval and train mode (the same convolutions, summed in another
order), the analysis 1e-8 (draws injected from one numpy stream per
package; each jitted JAX function traced, and so drawing, once).
"""

import functools
import json
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.data import loader as jloader
from generative_physics_informed_pde_tpu.factories import data as jdata
from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu.inference import (
    analysis as janalysis)
from generative_physics_informed_pde_tpu.inference import variational as jva
from generative_physics_informed_pde_tpu.models import codec as jcodec
from generative_physics_informed_pde_tpu.models import components as jcomp
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.data import (
    BatchedOverSampler, DataLoader, TensorDataset, minibatch_indices)
from generative_physics_informed_pde_tpu_torch.factories import (
    data as tdata)
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.inference import (
    analysis as tanalysis)
from generative_physics_informed_pde_tpu_torch.inference import (
    variational as tva)
from generative_physics_informed_pde_tpu_torch.models import (
    DenseED, ROM, components as tcomp, pad_channels, softplus4)
from generative_physics_informed_pde_tpu_torch.utils import (
    count_parameters, freeze_mask, freeze_optimizer, global_norm)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small ops, which slow down by tens of
    times when the test workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ------------------------------------------------------------ FEM extras
def test_bc_encoding_round_trip():
    bce = tfem.BoundaryConditionEnsemble.from_factory(
        "NDP", 5, np.random.default_rng(0))
    enc = bce.encode()
    enc[0, 0] += 1.0  # a copy: the ensemble keeps its own
    assert not np.array_equal(enc, bce.thetas)
    again = tfem.BoundaryConditionEnsemble.from_encoding("NDP", bce.encode())
    assert np.array_equal(again.thetas, bce.thetas)
    jb = jfem.BoundaryConditionEnsemble.from_factory(
        "NDP", 5, np.random.default_rng(0))
    assert np.array_equal(bce.encode(), jb.encode())
    grid = tfem.StructuredTriGrid(6, 4)
    assert tfem.DirichletProfile(grid).n_constrained == \
        jfem.DirichletProfile(jfem.StructuredTriGrid(6, 4)).n_constrained \
        == 10


def test_random_field_numpy_side_matches_jax():
    X = tfem.pixel_center_points(6, 5)
    assert _rel(tfem.squared_exponential_covariance(X, 0.8, 0.3),
                jfem.squared_exponential_covariance(X, 0.8, 0.3)) <= 1e-14
    for kw in (dict(truncation=None), dict(truncation="adaptive"),
               dict(method="fft")):
        t = tfem.GaussianRandomField.from_image(12, 12, 0.4, 0.8, 0.15, **kw)
        j = jfem.GaussianRandomField.from_image(12, 12, 0.4, 0.8, 0.15, **kw)
        got = t.sample_numpy(np.random.default_rng(3), 4)
        assert got.shape == (4, 12, 12)
        assert np.array_equal(got, j.sample_numpy(np.random.default_rng(3),
                                                  4))
    kl_t = tfem.GaussianRandomField.from_image(12, 12, 0.4, 0.8, 0.15,
                                               truncation="adaptive")
    kl_j = jfem.GaussianRandomField.from_image(12, 12, 0.4, 0.8, 0.15,
                                               truncation="adaptive")
    assert _rel(kl_t.subspace(), kl_j.subspace()) <= 1e-12
    assert kl_t.subspace().shape[1] == kl_t.dim_in
    with pytest.raises(RuntimeError, match="truncated"):
        tfem.GaussianRandomField.from_image(6, 6, 0.4, 0.8, 0.15).subspace()


def test_rom_stiffness_matches_jax():
    tphys = tfem.make_fom_rom_pair("NDP", 3, 2, 1, device="cpu")
    jphys = jfem.make_fom_rom_pair("NDP", 3, 2, 1)
    trom = ROM.from_physics(tphys["rom"]).double()
    jrom = jcomp.ROM.from_physics(jphys["rom"])
    X = np.exp(np.random.default_rng(2).normal(size=(3, trom.dim_in)))
    for bc in (True, False):
        assert _rel(trom.get_stiffness(torch.as_tensor(X), bc),
                    jrom.get_stiffness(jnp.asarray(X), bc)) <= 1e-13
    assert (trom.dim_in, trom.dim_out) == (jrom.dim_in, jrom.dim_out)


# ------------------------------------------------------------------ data
def test_samplers():
    gen = torch.Generator().manual_seed(0)
    s = BatchedOverSampler(batch_size=7, num_batches=3, num_data=5)
    batches = list(s.batches(gen))
    assert len(s) == len(batches) == 3
    for b in batches:
        assert b.shape == (7,) and int(b.min()) >= 0 and int(b.max()) < 5
    idx = minibatch_indices(gen, 10, 10)
    assert sorted(idx.tolist()) == list(range(10))  # without replacement
    X, Y = np.arange(12.0).reshape(6, 2), np.arange(6)
    ds = TensorDataset((X, Y))
    assert len(ds) == 6
    x, y = ds[np.array([4, 1])]
    assert np.array_equal(x, X[[4, 1]]) and np.array_equal(y, [4, 1])
    assert np.array_equal(TensorDataset((X,))[2], X[2])
    with pytest.raises(ValueError):
        TensorDataset((X, Y[:3]))


def test_get_random_subset_matches_jax():
    X = np.random.default_rng(0).normal(size=(12, 4, 4))
    chunks = {"a": 5, "b": 7}
    perm = np.random.default_rng(1).permutation(12)
    jl = jloader.DataLoader(X)
    jl.randomized_partition(chunks, permutation=perm)
    tl = DataLoader(X)
    tl.randomized_partition(chunks, permutation=perm)
    jds = jl.construct_dataset_dictionary(identifier="default",
                                          dtype=jnp.float64)
    tds = tl.construct_dataset_dictionary(identifier="default",
                                          dtype=torch.float64, device="cpu")
    for label in chunks:
        got = tds[label].get("X", random_subset=3,
                             rng=np.random.default_rng(7))
        want = jds[label].get("X", random_subset=3,
                              rng=np.random.default_rng(7))
        assert got.shape == (3, 4, 4)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert tds[label].get("X").shape[0] == chunks[label]


def _tiny(mod, rf_mod, N=6, identifier="tinytest"):
    class Tiny(mod.DataFactory):
        _identifier = identifier
        _N = N
        _N_unsupervised = 4
        _rfs = rf_mod.GaussianRandomField.from_image(8, 8, 0.0, 1.0, 0.3)
    return Tiny


def test_dataset_cache_staleness(tmp_path, recwarn):
    """After tests/test_aux_components.py:242: a hit with the same
    parameters, a stale cache resampled when the preset changes."""
    path = str(tmp_path) + "/"
    Tiny = _tiny(tdata, tfem)
    dl1, dlu1 = Tiny(path=path).setup(device="cpu")
    assert dl1.N == 6 and dlu1.N == 4 and dlu1._lock_physics_assembly
    n_warn = len(recwarn)
    dl2, _ = Tiny(path=path).setup(device="cpu")
    assert dl2.N == 6 and len(recwarn) == n_warn
    assert np.array_equal(dl2.X, dl1.X)
    with pytest.warns(RuntimeWarning, match="stale"):
        dl3, _ = _tiny(tdata, tfem, N=10)(path=path).setup(device="cpu")
    assert dl3.N == 10
    dl4, _ = Tiny(path=path).force_setup(device="cpu")
    assert dl4.N == 6
    with pytest.raises(ValueError, match="slash"):
        Tiny(path=str(tmp_path)).setup(device="cpu")
    with pytest.raises(ValueError, match="path"):
        Tiny().force_setup(device="cpu")
    with pytest.raises(ValueError):
        Tiny(path=path).setup(N_u_max=2, device="cpu")


def test_dataset_cache_is_shared_with_jax(tmp_path):
    """A cache written by either package is a hit for the other: the same
    fields, no warning, the same sidecar JSON."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / writer) + "/"
        make = {"jax": lambda: _tiny(jdata, jfem)(path=path).setup(),
                "port": lambda: _tiny(tdata, tfem)(path=path).setup(
                    device="cpu")}
        dl_w, dlu_w = make[writer]()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            dl_r, dlu_r = make[reader]()
        for a, b in ((dl_w, dl_r), (dlu_w, dlu_r)):
            assert np.array_equal(np.asarray(a.X), np.asarray(b.X))
    for ext in (".labeled.npz.meta.json", ".unlabeled.npz.meta.json"):
        texts = [(tmp_path / w / f"tinytest{ext}").read_text()
                 for w in ("jax", "port")]
        assert texts[0] == texts[1] and json.loads(texts[0])["py"] == 8


# ---------------------------------------------------------------- DenseED
@pytest.fixture(scope="module")
def dense_ed():
    """A narrow Flax DenseED (growth 4, init 8, blocks (1, 2, 1)) at 16^2:
    its f64 variables, its eval output and its train-mode output and
    batch statistics (each traced once)."""
    kw = dict(out_channels=2, blocks=(1, 2, 1), growth_rate=4,
              init_features=8)
    jm = jcodec.DenseED(**kw)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 16, 16, 1)))
    variables = jax.jit(lambda v: jm.init(jax.random.PRNGKey(0), v,
                                          train=False))(x)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       variables)
    ev = jax.jit(lambda v, x_: jm.apply(v, x_, train=False))(variables, x)
    tr, upd = jax.jit(lambda v, x_: jm.apply(
        v, x_, train=True, mutable=["batch_stats"]))(variables, x)
    return kw, np.asarray(x), variables, np.asarray(ev), np.asarray(tr), upd


def _port_dense_ed(kw, variables, **extra):
    tm = DenseED(**kw, **extra).double()
    return load_flax_variables(tm, variables["params"],
                               variables["batch_stats"])


@pytest.mark.parametrize("act", [None, "tanh", "relu", "lrelu", "sigmoid",
                                 "softplus"])
def test_dense_ed_eval_matches_flax(dense_ed, act):
    """Eval mode, every output activation (the Flax module applies it to
    its last output, ``_ACTIVATIONS[act]``)."""
    kw, x, variables, ev, _, _ = dense_ed
    want = ev if act is None else np.asarray(
        jcodec._ACTIVATIONS[act](jnp.asarray(ev)))
    tm = _port_dense_ed(kw, variables, out_activation=act).eval()
    got = tm(torch.as_tensor(x))
    assert got.shape == (3, 16, 16, 2)
    assert _rel(got.detach(), want) <= 1e-10


def test_dense_ed_train_mode_matches_flax(dense_ed):
    kw, x, variables, _, want, upd = dense_ed
    tm = _port_dense_ed(kw, variables).train()
    got = tm(torch.as_tensor(x))
    assert _rel(got.detach(), want) <= 1e-10
    jstats = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    tstats = dict(tm.named_buffers())
    assert len(jstats) == len([n for n in tstats if "running" in n])
    for path, leaf in jstats:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [{"mean": "running_mean",
                                      "var": "running_var"}[keys[-1]]])
        assert _rel(tstats[name], leaf) <= 1e-10, name
    # one backward runs
    got.square().sum().backward()
    assert all(p.grad is not None for p in tm.parameters())


def test_dense_ed_checks_and_pad_channels():
    with pytest.raises(ValueError, match="odd"):
        DenseED(out_channels=1, blocks=(1, 1))
    with pytest.raises(ValueError):
        DenseED(out_channels=1, blocks=(1,), out_activation="swish")
    x = np.random.default_rng(1).normal(size=(2, 3, 3, 5))
    for m in (0, 4, 5, 8):
        assert np.array_equal(
            pad_channels(torch.as_tensor(x), m).numpy(),
            np.asarray(jcodec.pad_channels(jnp.asarray(x), m)))
    z = np.linspace(-3.0, 3.0, 13)
    assert _rel(softplus4(torch.as_tensor(z)),
                jcodec.softplus4(jnp.asarray(z))) <= 1e-14


# --------------------------------------------------------------- analysis
STAND_IN = dict(num_refines=2, dec_blocks=(1,), dtype="float64")  # 16^2


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
    """Every draw of both analyses from one numpy stream per package, in
    call order."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)

    def jn(shape):
        return jnp.asarray(rj.standard_normal(tuple(shape)))

    def tn(shape):
        return torch.as_tensor(rt.standard_normal(tuple(shape)))

    def j_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jn((m.shape[0], n, m.shape[-1]))

    def t_all(params, generator, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + torch.exp(ls) * tn((m.shape[0], n, m.shape[-1]))

    def j_one(params, index, key, n):
        m, ls = params["mean"][index], params["logsigma"][index]
        return m + jnp.exp(ls) * jn((n,) + m.shape)

    def t_one(params, index, generator, n):
        m, ls = params["mean"][index], params["logsigma"][index]
        return m + torch.exp(ls) * tn((n,) + tuple(m.shape))

    def j_gp(gp_out, key):
        if not isinstance(gp_out, tuple):
            return gp_out
        mean, logsigmas = gp_out
        return mean + jnp.exp(logsigmas) * jn(logsigmas.shape)

    def j_propagate(self, params, effprops, F, key):
        mean, logsigmas = self(params, effprops, F)
        return mean + jnp.exp(logsigmas) * jn(mean.shape)

    for mod, name, fn in (
            (jva, "sample_all_components", j_all),
            (jva, "sample_component", j_one),
            (janalysis, "propagate_gp_samples", j_gp),
            (jcomp.ReducedOrderModelOperator, "propagate_samples",
             j_propagate),
            (janalysis, "jax", _Jax(lambda shape: rj.standard_normal(
                tuple(shape)))),
            (tva, "sample_all_components", t_all),
            (tva, "sample_component", t_one),
            (tcomp, "standard_normal", lambda shape, like, g=None:
             tn(shape)),
            (tanalysis, "standard_normal", lambda shape, like, g=None:
             tn(shape))):
        monkeypatch.setattr(mod, name, fn)


@pytest.fixture(scope="module")
def models():
    """The highres32 preset cut to 16^2 in both packages, the JAX model's
    Flax state carried into the port's (after
    tests/test_inference_extra.py:56)."""
    N = 4
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
    return jm, params, bs, model, data


def test_analysis_from_encoder_eval_all_and_x_samples(models, monkeypatch):
    jm, params, bs, model, data = models
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    td = {k: torch.as_tensor(v) for k, v in data.items()}
    ja, jq = janalysis.Analysis.from_encoder(jm, params, bs, jd)
    ta, tq = tanalysis.Analysis.from_encoder(model, td)
    for k in ("mean", "logsigma"):
        assert _rel(tq[k], jq[k]) <= 1e-10
    S = 6
    _inject(monkeypatch, 17)
    # the JAX analysis's jitted functions, each traced once, draw at trace
    # time: one call each
    j_none = ja.eval_all(params, bs, jq, jax.random.PRNGKey(0), S)
    jx = ja.sample_predictive_x(params, bs, jq, jax.random.PRNGKey(2), S, 1)
    jy = ja.sample_predictive_y(params, jq, jax.random.PRNGKey(3), S,
                                index=2)
    t_none = ta.eval_all(tq, None, S)
    tx = ta.sample_predictive_x(tq, None, S, 1)
    ty = ta.sample_predictive_y(tq, None, S, index=2)
    assert set(t_none) == set(j_none) == {"relerr_x", "logscore_x",
                                         "relerr_y", "r2_y", "logscore_y"}
    for k in j_none:
        assert np.isfinite(t_none[k]) and _rel(t_none[k], j_none[k]) <= 1e-8
    assert tx.shape == (S, 16, 16) and _rel(tx, jx) <= 1e-8
    assert ty.shape == (S, jm.g.dim_out) and _rel(ty, jy) <= 1e-8
    # at an iteration the metrics go into the series and the x scalars
    # come back; the same draws give the same values
    _inject(monkeypatch, 17)
    t_at5 = ta.eval_all(tq, None, S, iteration=5)
    assert set(t_at5) == {"relerr_x", "logscore_x"}
    for k in ("relerr_x", "relerr_y", "r2_y", "logscore_y", "logscore_x"):
        assert ta.series[k].iteration == [5]
        assert ta.series[k].final() == t_none[k]
        assert ta.series[k].min() == ta.series[k].max() == t_none[k]


# ------------------------------------------------------------ parameters
def test_param_utils_and_freezing():
    """After tests/test_model_variants.py:88."""
    params = {"f": {"w": torch.ones(3, 4, requires_grad=True)},
              "q_z": {"mean": torch.ones(5, requires_grad=True)}}
    assert count_parameters(params) == 17
    np.testing.assert_allclose(float(global_norm(params).detach()),
                               np.sqrt(17.0))
    assert freeze_mask(params, ["f"]) == {"f.w": "frozen",
                                          "q_z.mean": "trainable"}
    opt = freeze_optimizer(functools.partial(torch.optim.SGD, lr=1.0),
                           params, frozen=["f"])
    for p in (params["f"]["w"], params["q_z"]["mean"]):
        p.grad = torch.ones_like(p)
    opt.step()
    assert torch.equal(params["f"]["w"], torch.ones(3, 4))
    assert torch.equal(params["q_z"]["mean"], torch.zeros(5))


def test_frozen_block_under_adam_stays_bit_equal():
    """A frozen block changes by exactly nothing over 3 Adam steps; the
    trainable one steps as Adam over all the parameters steps it."""
    def net():
        torch.manual_seed(0)
        return torch.nn.ModuleDict({
            "encoder": torch.nn.Linear(4, 3).double(),
            "head": torch.nn.Linear(3, 2).double()})

    frozen_run, plain_run = net(), net()
    before = {n: p.detach().clone()
              for n, p in frozen_run.named_parameters()}
    assert count_parameters(frozen_run) == 4 * 3 + 3 + 3 * 2 + 2
    adam = functools.partial(torch.optim.Adam, lr=0.1)
    opts = (freeze_optimizer(adam, frozen_run, ["encoder"]),
            adam(plain_run.parameters()))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 4)))
    for _ in range(3):
        for m, opt in zip((frozen_run, plain_run), opts):
            opt.zero_grad()
            m["head"](torch.tanh(m["encoder"](x))).square().sum().backward()
            opt.step()
    for n, p in frozen_run.named_parameters():
        if n.startswith("encoder."):
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n
    # the head saw the same (frozen-encoder) inputs only at step one, so
    # compare one step: a fresh pair
    a, b = net(), net()
    oa, ob = freeze_optimizer(adam, a, ["encoder"]), adam(b.parameters())
    for m, opt in ((a, oa), (b, ob)):
        m["head"](torch.tanh(m["encoder"](x))).square().sum().backward()
        opt.step()
    assert torch.equal(a["head"].weight, b["head"].weight)
    assert global_norm(frozen_run).dtype == torch.float64


def test_conversions():
    """After tests/test_aux_components.py:195."""
    import scipy.sparse as sp
    from generative_physics_informed_pde_tpu_torch.utils.conversions import (
        convert_scipy_sparse_to_dense, convert_scipy_sparse_to_sparse_coo)
    A = sp.random(6, 5, density=0.4, random_state=0, format="csr")
    B = convert_scipy_sparse_to_sparse_coo(A, device="cpu")
    assert B.is_sparse
    np.testing.assert_allclose(B.to_dense().numpy(), A.todense(), rtol=1e-12)
    D = convert_scipy_sparse_to_dense(A, device="cpu")
    np.testing.assert_allclose(D.numpy(), A.todense())


# ------------------------------------------------------ trainer and plots
@pytest.fixture(scope="module")
def trainer():
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer, TrainerParameters)
    rf = tfem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = rf.sample_numpy(np.random.default_rng(0), 20)
    p = TrainerParameters()
    p.identifier = "highres32"
    p.debug = True
    p.trainer["lr_init"] = 1e-2
    p.data.update(N_u=4, N_s=8, N_u_max=4, N_s_max=8, N_val=4,
                  armortized_bs=4)
    dl, dlu = DataLoader(X[:12]), DataLoader(X[12:16])
    dlu.lock_physics_assembly()
    # labels in dispatches of 8, not the loader's default 256
    dl.assemble(highres32().physics(device="cpu"), label_batch=8)
    tr = CreateTrainer(p, dl, dlu, device="cpu")
    tr.run(6, verbose=False)  # a monitor point at step 5 (debug)
    return tr, dl, dlu


def test_trainer_accessors(trainer):
    tr, dl, dlu = trainer
    assert tr.dl is dl and tr.dlu is dlu
    assert tr.mf is tr._mf and tr.mf.physics(device="cpu")["fom"].dim_out \
        == tr.physics["fom"].dim_out
    with pytest.raises(NotImplementedError):
        tr.reset()


def test_plots_smoke(trainer):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    from generative_physics_informed_pde_tpu_torch.utils.plotting import (
        plot_2d, plot_elbo, plot_function_2d, plot_predictive_logscore)
    tr = trainer[0]
    grid = tr.physics["fom"].grid
    ax = plot_function_2d(grid, np.arange(grid.n_nodes, dtype=float),
                          title="nodes")
    assert ax.get_title() == "nodes"
    with pytest.raises(ValueError):
        plot_function_2d(grid, np.zeros(3))
    assert tr._monitor["elbo"]
    plot_elbo(tr)
    plot_predictive_logscore(tr)
    fig = plot_2d(tr, [0, 2], n_monte_carlo=8)
    assert len(fig.axes) == 4
    plt.close("all")
