"""Dataset management: loaders, partitioned dataset views, minibatches."""

from .loader import DataLoader, DataSet
from .sampling import minibatch_indices

__all__ = ["DataLoader", "DataSet", "minibatch_indices"]
