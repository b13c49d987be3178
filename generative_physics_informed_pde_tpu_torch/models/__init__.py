"""Networks and model components of the port."""

from .codec import (BatchNorm, DenseBlock, DenseED, DenseLayer, LastDecoding,
                    NormReluConv, SameConv2d, TransitionDown, TransitionUp,
                    channel_dropout, checkpointed, pad_channels,
                    same_padding, softplus4, upsample_bilinear_2x,
                    upsample_nearest_2x)
from .decoder import CNNDecoder, LinearDecoder, NeuralNetworkDecoder
from .encoder import (CNNEncoder, LinearEncoder, NeuralNetworkEncoder,
                      SplitHeads)
from .mlp import FeedforwardNeuralNetwork, architecture_from_linear_decay
from .components import (EffectivePropertyMap, ROM,
                         ReducedOrderModelOperator, propagate_gp_samples)
from .generative import DiscriminativeModel, GenerativeModel
from .calibration import (optimize_effective_properties,
                          reduced_order_model_solve)

__all__ = [
    "BatchNorm", "DenseBlock", "DenseED", "DenseLayer", "LastDecoding",
    "NormReluConv", "SameConv2d", "TransitionDown", "TransitionUp",
    "channel_dropout", "checkpointed", "pad_channels", "same_padding",
    "softplus4", "upsample_bilinear_2x", "upsample_nearest_2x",
    "CNNDecoder", "LinearDecoder", "NeuralNetworkDecoder", "CNNEncoder",
    "LinearEncoder", "NeuralNetworkEncoder", "SplitHeads",
    "FeedforwardNeuralNetwork", "architecture_from_linear_decay",
    "EffectivePropertyMap", "ROM", "ReducedOrderModelOperator",
    "propagate_gp_samples", "DiscriminativeModel", "GenerativeModel",
    "optimize_effective_properties", "reduced_order_model_solve",
]
