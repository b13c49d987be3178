"""Variational inference: per-datapoint Gaussian posteriors, likelihood and
KL primitives, the prediction ensemble and the analysis metrics."""

from . import variational
from .analysis import Analysis, DataPair
from .likelihoods import (LOG_2PI, bernoulli_log_likelihood,
                          coefficient_of_determination,
                          diagonal_gaussian_log_likelihood,
                          predictive_logscore, relative_error,
                          relative_error_batched, reparametrize,
                          unit_gaussian_kld)
from .prediction import PredictionEnsemble

__all__ = [
    "variational", "LOG_2PI", "reparametrize",
    "diagonal_gaussian_log_likelihood", "unit_gaussian_kld",
    "bernoulli_log_likelihood", "relative_error", "relative_error_batched",
    "coefficient_of_determination", "predictive_logscore",
    "Analysis", "DataPair", "PredictionEnsemble",
]
