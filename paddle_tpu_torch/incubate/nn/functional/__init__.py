from .flash_attention import grouped_pv_out, grouped_qk_logits
from .fused_ops import (fused_rms_norm, fused_rotary_position_embedding,
                        swiglu)
from .paged_kv import (PagedCache, alloc_block_tables,
                       block_grouped_query_attention,
                       block_multihead_attention, init_block_cache)

__all__ = ["PagedCache", "alloc_block_tables",
           "block_grouped_query_attention", "block_multihead_attention",
           "fused_rms_norm", "fused_rotary_position_embedding",
           "grouped_pv_out", "grouped_qk_logits", "init_block_cache",
           "swiglu"]
