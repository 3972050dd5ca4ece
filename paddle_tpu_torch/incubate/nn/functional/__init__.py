from .flash_attention import grouped_pv_out, grouped_qk_logits
from .fused_ops import (fused_rms_norm, fused_rotary_position_embedding,
                        swiglu)
from .paged_kv import (PagedCache, alloc_block_tables,
                       block_grouped_query_attention,
                       block_grouped_query_attention_quant,
                       block_multihead_attention,
                       block_multihead_attention_quant, init_block_cache,
                       init_block_cache_quant)

__all__ = ["PagedCache", "alloc_block_tables",
           "block_grouped_query_attention",
           "block_grouped_query_attention_quant",
           "block_multihead_attention", "block_multihead_attention_quant",
           "fused_rms_norm", "fused_rotary_position_embedding",
           "grouped_pv_out", "grouped_qk_logits", "init_block_cache",
           "init_block_cache_quant", "swiglu"]
