"""``paddle.incubate.nn`` of the port (``paddle_tpu/incubate/nn/``): the
fused transformer layers and their functional forms."""
from . import functional  # noqa: F401
from .layer.fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                      FusedFeedForward,
                                      FusedMultiHeadAttention,
                                      FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer",
           "FusedBiasDropoutResidualLayerNorm"]
