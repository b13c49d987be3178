"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from .stencil import apply_stencil, apply_stencil_reference

__all__ = ["apply_stencil", "apply_stencil_reference"]
