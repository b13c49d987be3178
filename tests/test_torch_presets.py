"""The port's 'highres' model and data presets against the JAX package's
(``factories/model.py`` ``highres``, ``factories/data.py`` ``highres``).

Model: the same physics (64^2 'ND' FOM, 8^2 ROM, the interpolator W to
1e-12), the same parameter count per module, and the Flax parameter tree
of the JAX preset loads into the port's modules leaf for leaf, after which
the decoder and the encoder agree with Flax in eval mode (f64, 1e-8:
convolution sums in another order).  Data: the same pool sizes and field
(mean, stddev, corrlength, adaptive KL truncation); without a
``cdata/highres.labeled.npz`` the labeled pool is drawn from a generator
seeded 0, the unlabeled one from a generator seeded 1, and nothing is
written.  The 4096-point eigendecomposition of the preset's own field is
left to the card (``chip_smoke.py``); the drawing is checked here on a
small field put in its place.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from generative_physics_informed_pde_tpu.factories import data as jdata
from generative_physics_informed_pde_tpu.factories import model as jmodel
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.factories import (
    DataFactory, highres)
from generative_physics_informed_pde_tpu_torch.factories import data as tdata
from generative_physics_informed_pde_tpu_torch.fem import randomfield as trf


def _count(tree):
    return sum(int(np.prod(np.shape(x)))
               for x in jax.tree_util.tree_leaves(tree))


def test_highres_model_preset_matches_jax():
    jphys, jm, _, _, jdt = jmodel.highres(dtype="float64").setup()
    tphys, tm, _, tenc, tdt = highres(dtype="float64").setup(device="cpu")
    assert tdt == torch.float64 and tenc is tm.encoder
    for key in ("fom", "rom"):
        assert (tphys[key].grid.nx, tphys[key].grid.ny) == \
            (jphys[key].grid.nx, jphys[key].grid.ny)
        assert tphys[key].physics_id == jphys[key].physics_id == "ND"
    assert tphys["fom"].grid.nx == 64 and tphys["rom"].grid.nx == 8
    np.testing.assert_allclose(np.asarray(tphys["W"]),
                               np.asarray(jphys["W"]), rtol=1e-12,
                               atol=1e-12)
    assert tm.f.DenseBlock_1.DenseLayer_0.drop_rate == 0.2
    assert tm.encoder.TransitionDown_2.NormReluConv_1.drop_rate == 0.2
    params, bs = jm.init_params(jax.random.PRNGKey(0), {}, (64, 64))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    params)
    bs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), bs)
    for key, module in (("f", tm.f), ("encoder", tm.encoder),
                        ("gp", tm.gp), ("g", tm.g)):
        assert sum(p.numel() for p in module.parameters()) \
            == _count(params[key]), key
    load_flax_variables(tm, params, bs)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 64))
    mj, lj = jax.jit(lambda v, z: jm.f.apply(v, z, train=False))(
        {"params": params["f"], "batch_stats": bs["f"]}, jnp.asarray(z))
    mt, lt = tm.apply_decoder(torch.as_tensor(z), train=False)
    assert mt.shape == (3, 64, 64)
    for got, want in ((mt, mj), (lt, lj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())
    x = rng.normal(size=(3, 64, 64))
    ej, sj = jax.jit(lambda v, x: jm.encoder.apply(v, x, train=False))(
        {"params": params["encoder"], "batch_stats": bs["encoder"]},
        jnp.asarray(x))
    et, st = tm.apply_encoder(torch.as_tensor(x), train=False)
    for got, want in ((et, ej), (st, sj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())


def test_highres_data_preset_matches_jax(tmp_path, monkeypatch):
    j = jdata.highres()
    t = DataFactory.FromIdentifier("highres")
    assert (t._N, t._N_unsupervised) == (j._N, j._N_unsupervised) \
        == (2048, 20480)
    for attr in ("mean", "stddev", "corrlength", "truncation", "py", "px",
                 "method", "kernel"):
        assert getattr(t._rfs, attr) == getattr(j._rfs, attr), attr
    np.testing.assert_array_equal(t._rfs.X, j._rfs.X)
    assert t._rfs._resolved_method == "kl"
    assert not (tdata.DATAPATH / "highres.labeled.npz").exists()

    # the drawing on a small field in the preset's place
    small = trf.GaussianRandomField.from_image(8, 8, 0.4, 0.8, 0.1,
                                               truncation="adaptive")
    monkeypatch.setattr(t, "_rfs", small)
    monkeypatch.setattr(t, "_N", 5)
    monkeypatch.setattr(t, "path", tmp_path)
    dl, dlu = t.setup(N_u_max=3, device="cpu")
    want = small.sample(torch.Generator().manual_seed(0), batch_size=5,
                        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(dl.X, want.numpy())
    want = small.sample(torch.Generator().manual_seed(1), batch_size=3,
                        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(dlu.X, want.numpy())
    assert list(tmp_path.iterdir()) == []  # nothing written
    # a pool larger than one sampling batch is drawn in batches
    monkeypatch.setattr(trf.GaussianRandomField, "max_sample_batch", 2)
    assert t.unlabeled(5, torch.Generator().manual_seed(1),
                       device="cpu").X.shape == (5, 8, 8)
