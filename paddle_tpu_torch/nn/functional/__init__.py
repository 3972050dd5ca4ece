from .activation import gelu
from .attention import scaled_dot_product_attention
from .common import embedding, linear, matmul
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "embedding", "gelu", "layer_norm", "linear",
           "matmul", "scaled_dot_product_attention"]
