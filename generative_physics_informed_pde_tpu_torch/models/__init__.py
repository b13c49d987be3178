"""Networks and model components of the port."""

from .codec import (BatchNorm, DenseBlock, DenseLayer, LastDecoding,
                    NormReluConv, SameConv2d, TransitionDown, TransitionUp,
                    channel_dropout, checkpointed, same_padding,
                    upsample_bilinear_2x, upsample_nearest_2x)
from .decoder import CNNDecoder, LinearDecoder, NeuralNetworkDecoder
from .encoder import (CNNEncoder, LinearEncoder, NeuralNetworkEncoder,
                      SplitHeads)
from .mlp import FeedforwardNeuralNetwork, architecture_from_linear_decay
from .components import EffectivePropertyMap, ROM, ReducedOrderModelOperator
from .generative import DiscriminativeModel, GenerativeModel

__all__ = [
    "BatchNorm", "DenseBlock", "DenseLayer", "LastDecoding", "NormReluConv",
    "SameConv2d", "TransitionDown", "TransitionUp", "channel_dropout",
    "checkpointed", "same_padding", "upsample_bilinear_2x",
    "upsample_nearest_2x", "CNNDecoder", "LinearDecoder",
    "NeuralNetworkDecoder", "CNNEncoder", "LinearEncoder",
    "NeuralNetworkEncoder", "SplitHeads", "FeedforwardNeuralNetwork",
    "architecture_from_linear_decay", "EffectivePropertyMap", "ROM",
    "ReducedOrderModelOperator", "DiscriminativeModel", "GenerativeModel",
]
