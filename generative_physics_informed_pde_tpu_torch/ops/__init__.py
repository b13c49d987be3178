"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from .stencil import (apply_stencil, apply_stencil_reference,
                      apply_stencil_sym, apply_stencil_sym_reference)

__all__ = ["apply_stencil", "apply_stencil_reference", "apply_stencil_sym",
           "apply_stencil_sym_reference"]
