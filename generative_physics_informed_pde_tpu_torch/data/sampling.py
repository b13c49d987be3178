"""Minibatch index draws.

Port of ``minibatch_indices`` from
``generative_physics_informed_pde_tpu/data/sampling.py``, drawing from an
explicit ``torch.Generator`` on the generator's device.
"""

from __future__ import annotations

from typing import Optional

import torch


def minibatch_indices(generator: Optional[torch.Generator], num_data: int,
                      batch_size: int, device=None) -> torch.Tensor:
    """Uniform minibatch of ``batch_size`` distinct indices into
    ``range(num_data)``, on ``device`` (default: the generator's)."""
    gen_device = generator.device if generator is not None else device
    idx = torch.randperm(num_data, generator=generator,
                         device=gen_device)[:batch_size]
    return idx if device is None else idx.to(device)
