from .serving import (GenerationSession, ModelAdapter, aot_generate,
                      get_model_adapter, sample_logits)

__all__ = ["GenerationSession", "ModelAdapter", "aot_generate",
           "get_model_adapter", "sample_logits"]
