"""generative_physics_informed_pde_tpu_torch: the PyTorch/CUDA port of
``generative_physics_informed_pde_tpu`` for an NVIDIA H100.

It imports torch, numpy and the standard library only -- never JAX, Flax,
optax or the JAX package, which stays beside it as the reference.  The
port's hand-written CUDA kernels live under ``ops/csrc`` and are built at
first use into ``build/torch_kernels/``.  Every entry point takes
``device=`` and defaults to ``"cuda"``; without a card it raises unless
the caller asks for ``device="cpu"``.

Ported so far (the highres32 and 'highres' 64^2 recipes): the
structured-grid FEM, the batched PCG solve on the stencil kernels (7-grid
and symmetric 4-grid forms) with its implicit-function VJP, Jacobi or the
multigrid V-cycle, the halo-padded symmetric apply, the Cholesky,
Karhunen-Loeve and FFT random fields, the data loader and presets, the
dense ROM solve, the DenseNet codec in train and eval mode with seeded
channel dropout, the ELBO, virtual observables (constraint and energy
arms, their stiffness applies on the stencil kernel), the prediction
ensemble, the analysis metrics, the SVI trainer and pad-to-bucket
serving.
"""

__version__ = "0.1.0"

from . import fem, models, ops  # noqa: F401
