"""Structured-grid FEM core of the port: grids, closed-form P1 assembly,
boundary conditions, pixel converters, interpolation, probes and
quantities of interest, the batched differentiable solve, the dense ROM
solve and Gaussian random fields."""

from .grid import StructuredTriGrid
from .assembly import (StencilOperator, assembly_tensor, element_stiffness,
                       dense_stiffness, coo_triples)
from .bc import (BoundaryConditionEnsemble, DirichletProfile, sample_theta,
                 THETA_DIM)
from .solvers import rom_solve, stiffness_from_tensor
from .physics import LinearEllipticPhysics, make_fom_rom_pair
from .interpolation import (p1_interpolation_matrix,
                            physics_resolution_interpolator)
from .pixels import PixelConverter
from .probe import Probe, QOI
from .randomfield import GaussianRandomField

__all__ = [
    "StructuredTriGrid", "StencilOperator", "assembly_tensor",
    "element_stiffness", "dense_stiffness", "coo_triples",
    "BoundaryConditionEnsemble", "DirichletProfile", "sample_theta",
    "THETA_DIM", "rom_solve", "stiffness_from_tensor",
    "LinearEllipticPhysics", "make_fom_rom_pair", "p1_interpolation_matrix",
    "physics_resolution_interpolator", "PixelConverter", "Probe", "QOI",
    "GaussianRandomField",
]
