"""Networks and model components of the port."""

from .codec import (BatchNorm, DenseBlock, DenseLayer, LastDecoding,
                    NormReluConv, SameConv2d, TransitionDown, TransitionUp,
                    channel_dropout, same_padding, upsample_nearest_2x)
from .decoder import CNNDecoder
from .encoder import CNNEncoder, SplitHeads
from .components import EffectivePropertyMap, ROM, ReducedOrderModelOperator
from .generative import DiscriminativeModel, GenerativeModel

__all__ = [
    "BatchNorm", "DenseBlock", "DenseLayer", "LastDecoding", "NormReluConv",
    "SameConv2d", "TransitionDown", "TransitionUp", "channel_dropout",
    "same_padding", "upsample_nearest_2x", "CNNDecoder", "CNNEncoder",
    "SplitHeads", "EffectivePropertyMap", "ROM", "ReducedOrderModelOperator",
    "DiscriminativeModel", "GenerativeModel",
]
