from .scheduler import AdmissionRejected, InvalidRequest, Scheduler
from .serving import (ContinuousBatchingSession, GenerationSession,
                      ModelAdapter, Request, aot_generate, get_model_adapter,
                      sample_logits)

__all__ = ["AdmissionRejected", "ContinuousBatchingSession",
           "GenerationSession", "InvalidRequest", "ModelAdapter", "Request",
           "Scheduler", "aot_generate", "get_model_adapter", "sample_logits"]
