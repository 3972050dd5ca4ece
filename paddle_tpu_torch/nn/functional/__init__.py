from .activation import gelu
from .attention import scaled_dot_product_attention
from .common import (alpha_dropout, dropout, dropout2d, dropout3d, embedding,
                     linear, matmul)
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import layer_norm

__all__ = ["alpha_dropout", "cross_entropy", "dropout", "dropout2d",
           "dropout3d", "embedding", "gelu", "layer_norm", "linear",
           "matmul", "scaled_dot_product_attention",
           "softmax_with_cross_entropy"]
