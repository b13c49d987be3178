"""Bidirectional DG0 <-> pixel-image converters.

Port of ``generative_physics_informed_pde_tpu/fem/pixels.py``: each image
pixel covers exactly two triangles; image -> function duplicates the pixel
value onto both cell dofs, function -> image averages them.  Both are
static index gathers on whatever device the input lies.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .grid import StructuredTriGrid


@dataclasses.dataclass(frozen=True)
class PixelConverter:
    """Image convention: row 0 = top of the domain."""

    grid: StructuredTriGrid

    @property
    def py(self) -> int:
        return self.grid.ny

    @property
    def px(self) -> int:
        return self.grid.nx

    @cached_property
    def _pixel_to_cells(self) -> np.ndarray:
        return self.grid.pixel_to_cells.reshape(-1, 2)

    @cached_property
    def _cell_to_pixel(self) -> np.ndarray:
        out = np.empty(self.grid.n_cells, dtype=np.int64)
        p2c = self._pixel_to_cells
        out[p2c[:, 0]] = np.arange(p2c.shape[0])
        out[p2c[:, 1]] = np.arange(p2c.shape[0])
        return out

    def function_to_image(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_cells) DG0 vectors -> (..., py, px) images."""
        idx = torch.as_tensor(self._pixel_to_cells, dtype=torch.long,
                              device=x.device)
        vals = x[..., idx]
        img = 0.5 * (vals[..., 0] + vals[..., 1])
        return img.reshape(x.shape[:-1] + (self.py, self.px))

    def image_to_function(self, images: torch.Tensor) -> torch.Tensor:
        """(..., py, px) images -> (..., n_cells) DG0 vectors."""
        flat = images.reshape(images.shape[:-2] + (-1,))
        idx = torch.as_tensor(self._cell_to_pixel, dtype=torch.long,
                              device=images.device)
        return flat[..., idx]
