"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from .stencil import (apply_stencil, apply_stencil_reference,
                      apply_stencil_sym, apply_stencil_sym_reference,
                      apply_stencil_sym_blocked,
                      apply_stencil_sym_blocked_reference, mask_blocked,
                      pad_blocked, pad_coefs_blocked, unpad_blocked)
from .vcycle import (vcycle_coarse, vcycle_correct, vcycle_presmooth,
                     vcycle_restrict, vcycle_smooth)

__all__ = ["apply_stencil", "apply_stencil_reference", "apply_stencil_sym",
           "apply_stencil_sym_reference", "apply_stencil_sym_blocked",
           "apply_stencil_sym_blocked_reference", "mask_blocked",
           "pad_blocked", "pad_coefs_blocked", "unpad_blocked",
           "vcycle_coarse", "vcycle_correct", "vcycle_presmooth",
           "vcycle_restrict", "vcycle_smooth"]
