"""Networks and model components of the port (inference mode)."""

from .codec import (BatchNorm, DenseBlock, DenseLayer, NormReluConv,
                    SameConv2d, TransitionDown, same_padding)
from .encoder import CNNEncoder, SplitHeads
from .components import EffectivePropertyMap, ROM, ReducedOrderModelOperator
from .generative import DiscriminativeModel, GenerativeModel

__all__ = [
    "BatchNorm", "DenseBlock", "DenseLayer", "NormReluConv", "SameConv2d",
    "TransitionDown", "same_padding", "CNNEncoder", "SplitHeads",
    "EffectivePropertyMap", "ROM", "ReducedOrderModelOperator",
    "DiscriminativeModel", "GenerativeModel",
]
