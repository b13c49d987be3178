"""The ``highres128`` preset's codec in train mode, bf16 against f32, in
both packages with the same Flax weights (BASELINE config 3's widths:
latent 64, an 8x8x2 latent image, decoder blocks (1, 2, 1, 1), growth 8;
encoder blocks (1, 2, 1)), on 16 fields of 128^2 as the card's check
uses.  It follows ``tests/test_torch_model_options.py``
``test_codec_bfloat16_matches_flax_bfloat16`` (the highres32 codec).

On the H100 the port's bf16 decoder moved 0.305 from its f32 output at an
output scale of 5.27; this holds whether the JAX package's bf16 codec
moves as far.  Measured on the CPU (max |diff| / max |f32 output|): the
bf16-to-f32 distance is 3.7% / 3.3% / 2.1% (decoder mean / log-sigma /
encoder mean) in the port against 3.6% / 3.7% / 2.3% in the JAX package;
the two packages' f32 outputs agree to 8.1e-6 and their bf16 outputs to
2.6%.  Tolerances: f32 port vs JAX 5e-5 of the scale (convolution sums
in another order); bf16 port vs JAX 0.05 of the scale (two roundings of
every bf16 convolution); the port's bf16-to-f32 distance within half of
the JAX package's, either way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.factories import model as jmf
from generative_physics_informed_pde_tpu_torch.convert import (
    load_flax_variables)
from generative_physics_informed_pde_tpu_torch.factories import model as tmf

N = 16
OUTPUTS = ("decoder mean", "decoder logsigma", "encoder mean")


@pytest.fixture(scope="module")
def outputs():
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, 64)),
                   np.float32)
    x = np.asarray(0.4 + jax.random.normal(jax.random.PRNGKey(2),
                                           (N, 128, 128)), np.float32)
    out = {}
    for cd in (None, "bfloat16"):
        _, jm, _, jenc, _ = jmf.ModelFactory.FromIdentifier(
            "highres128", compute_dtype=cd).setup()
        _, tm, _, tenc, _ = tmf.ModelFactory.FromIdentifier(
            "highres128", compute_dtype=cd).setup(device="cpu")
        fv = jm.f.init(jax.random.PRNGKey(1), jnp.asarray(z), train=False)
        ev = jenc.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
        load_flax_variables(tm.f, fv["params"], fv["batch_stats"])
        load_flax_variables(tenc, ev["params"], ev["batch_stats"])
        (mj, lj), _ = jm.f.apply(fv, jnp.asarray(z), train=True,
                                 mutable=["batch_stats"])
        (ej, _), _ = jenc.apply(ev, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        mt, lt = tm.apply_decoder(torch.tensor(z), train=True)
        et, _ = tm.apply_encoder(torch.tensor(x), train=True)
        assert mt.dtype == lt.dtype == et.dtype == torch.float32
        assert mt.shape == (N, 128, 128) and et.shape == (N, 64)
        out[cd] = {"jax": [np.asarray(a, np.float32) for a in (mj, lj, ej)],
                   "port": [t.detach().numpy() for t in (mt, lt, et)]}
    return out


def _dist(a, b, scale):
    return np.abs(a - b).max() / scale


@pytest.mark.parametrize("i", range(len(OUTPUTS)), ids=OUTPUTS)
def test_highres128_codec_bf16_distance_is_the_jax_packages(outputs, i):
    f32, bf16 = outputs[None], outputs["bfloat16"]
    scale = np.abs(f32["jax"][i]).max()
    assert _dist(f32["port"][i], f32["jax"][i], scale) <= 5e-5
    assert _dist(bf16["port"][i], bf16["jax"][i], scale) <= 0.05
    d_port = _dist(bf16["port"][i], f32["port"][i], scale)
    d_jax = _dist(bf16["jax"][i], f32["jax"][i], scale)
    assert 0 < d_jax and abs(d_port - d_jax) <= 0.5 * d_jax, (d_port, d_jax)
