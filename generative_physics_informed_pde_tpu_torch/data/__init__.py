"""Dataset management: loaders, partitioned dataset views, minibatches
and batch samplers."""

from .loader import DataLoader, DataSet
from .sampling import BatchedOverSampler, TensorDataset, minibatch_indices

__all__ = ["DataLoader", "DataSet", "BatchedOverSampler", "TensorDataset",
           "minibatch_indices"]
