"""generative_physics_informed_pde_tpu_torch: the PyTorch/CUDA port of
``generative_physics_informed_pde_tpu`` for an NVIDIA H100.

It imports torch, numpy and the standard library only -- never JAX, Flax,
optax or the JAX package, which stays beside it as the reference.  The
port's hand-written CUDA kernels live under ``ops/csrc`` and are built at
first use into ``build/torch_kernels/``.  Every entry point takes
``device=`` and defaults to ``"cuda"``; without a card it raises unless
the caller asks for ``device="cpu"``.

Ported so far (the highres32 labelling and serving slice): the
structured-grid FEM, the batched Jacobi-PCG label solve on the stencil
kernel, the dense ROM solve, the encoder / gp / g surrogate, pad-to-bucket
serving and the highres32 preset.
"""

__version__ = "0.1.0"

from . import fem, models, ops  # noqa: F401
