"""generative_physics_informed_pde_tpu_torch: the PyTorch/CUDA port of
``generative_physics_informed_pde_tpu`` for an NVIDIA H100.

It imports torch, numpy and the standard library only -- never JAX, Flax,
optax or the JAX package, which stays beside it as the reference.  The
port's hand-written CUDA kernels live under ``ops/csrc`` and are built at
first use into ``build/torch_kernels/``.  Every entry point takes
``device=`` and defaults to ``"cuda"``; without a card it raises unless
the caller asks for ``device="cpu"``.

Ported, everything the JAX package does (its TPU and JAX-transform
specifics aside, as ``tests/test_torch_api_coverage.py`` lists them): the
structured-grid FEM, the batched PCG solve on the stencil kernels (7-grid
and symmetric 4-grid forms) with its implicit-function VJP, Jacobi or the
multigrid V-cycle, the halo-padded symmetric apply, the Cholesky,
Karhunen-Loeve and FFT random fields, the data loader and presets, the
dense ROM solve, the DenseNet codec in train and eval mode with seeded
channel dropout, the ELBO, virtual observables (constraint and energy
arms, their stiffness applies on the stencil kernel), the prediction
ensemble, the analysis metrics, the SVI trainer with checkpoint and
resume, the metrics file, dataset files and pad-to-bucket serving with its
on-disk bundle of ``torch.export`` programs; probes and quantities of
interest, the study database and timers, and the parallel layer
(``torch.distributed``: process sweeps, one-device and process meshes,
batch sharding) that the uncertainty sweep
(``examples/torch_uncertainty_study.py``) runs on; the single-system
differentiable solve and ``cg``, force vectors, the ROM calibration, the
DenseED codec, the data presets' dataset cache, the samplers, the
parameter utilities, sparse conversions and plots; and training sharded
across processes (``Trainer.setup(mesh=...)``, ``parallel``'s shardings).
"""

__version__ = "0.1.0"

from . import fem, models, ops, parallel, utils  # noqa: F401
