"""Structured-grid FEM core of the port: grids, closed-form P1 assembly,
boundary conditions, pixel converters, interpolation, probes and
quantities of interest, force vectors, the single-system and batched
differentiable solves, the dense ROM solve and Gaussian random fields."""

from .grid import StructuredTriGrid
from .assembly import (StencilOperator, assembly_tensor, element_stiffness,
                       dense_stiffness, coo_matvec, coo_triples)
from .bc import (BoundaryConditionEnsemble, DirichletProfile, sample_theta,
                 THETA_DIM)
from .solvers import cg, rom_solve, stiffness_from_tensor, make_fom_solver
from .physics import LinearEllipticPhysics, make_fom_rom_pair
from .interpolation import (p1_interpolation_matrix,
                            physics_resolution_interpolator)
from .pixels import PixelConverter
from .probe import Probe, QOI
from .forcing import volume_force, neumann_force
from .randomfield import (GaussianRandomField, convert_log_mean_std,
                          pixel_center_points, squared_exponential_covariance)

__all__ = [
    "StructuredTriGrid", "StencilOperator", "assembly_tensor",
    "element_stiffness", "dense_stiffness", "coo_matvec", "coo_triples",
    "BoundaryConditionEnsemble", "DirichletProfile", "sample_theta",
    "THETA_DIM", "cg", "rom_solve", "stiffness_from_tensor",
    "make_fom_solver", "LinearEllipticPhysics", "make_fom_rom_pair",
    "p1_interpolation_matrix", "physics_resolution_interpolator",
    "PixelConverter", "GaussianRandomField", "convert_log_mean_std",
    "pixel_center_points", "squared_exponential_covariance",
    "Probe", "QOI", "volume_force", "neumann_force",
]
