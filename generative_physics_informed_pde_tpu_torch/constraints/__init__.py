"""Virtual observables: weak-form residual constraints, flux constraints,
linear-Gaussian conditioning and energy-based variants."""

from .virtual_observables import (
    QuerryPointEnsemble, BaseSampler, CoarseGrainedResidualSampler,
    GaussianSketchingSampler, RadialBasisFunctionSampler,
    FluxConstrainSampler, ConcatenatedSamplers, VirtualObservablesEnsemble,
    EnergyVirtualObservablesEnsemble, LinearTemperatureSchedule,
    ExponentialTemperatureSchedule, build_virtual_observables_ensemble,
    condition_ensemble, gamma_precision_beta, vo_spec_preset)
from .flux import FluxConstraintOperator

__all__ = [
    "QuerryPointEnsemble", "BaseSampler", "CoarseGrainedResidualSampler",
    "GaussianSketchingSampler", "RadialBasisFunctionSampler",
    "FluxConstrainSampler", "ConcatenatedSamplers",
    "VirtualObservablesEnsemble", "EnergyVirtualObservablesEnsemble",
    "LinearTemperatureSchedule", "ExponentialTemperatureSchedule",
    "build_virtual_observables_ensemble", "condition_ensemble",
    "gamma_precision_beta", "vo_spec_preset",
    "FluxConstraintOperator",
]
