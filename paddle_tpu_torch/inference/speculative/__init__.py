"""Speculative decoding: proposer/verifier serving over the paged-KV
pool. Counterpart of paddle_tpu/inference/speculative/.

The pieces:
- proposers (``NgramProposer`` / ``DraftModelProposer``) guess up to k
  continuation tokens per sequence;
- the serving sessions' VERIFY programs (``VerifyLadder``) score all
  k+1 positions in one dispatch over the target's paged KV, one CUDA
  graph per window width on a card;
- acceptance: the continuous session folds ``acceptance_fold`` into the
  verify graph (device accept: only two int32 vectors cross to the
  host); ``rejection`` keeps the plain-numpy host oracle of the same
  rules: greedy is byte-identical speculation on or off, sampled
  preserves the target distribution exactly.

Entry points: ``GenerationSession(..., speculative=...)``,
``ContinuousBatchingSession(..., speculative=...)``, and
``model.generate(..., speculative=...)`` through ``aot_generate``.
"""
from .config import SpeculativeConfig, resolve_speculative
from .proposers import (AdapterDraftStore, DraftModelProposer,
                        NgramProposer, build_proposer)
from .rejection import (UniformStream, filtered_probs, greedy_accept,
                        rejection_accept, sample_from)
from .verify import (VerifyLadder, acceptance_fold, filtered_probs_torch,
                     pow2_width)

__all__ = ["SpeculativeConfig", "resolve_speculative", "NgramProposer",
           "DraftModelProposer", "AdapterDraftStore", "build_proposer",
           "filtered_probs", "greedy_accept", "rejection_accept",
           "sample_from", "UniformStream", "VerifyLadder",
           "acceptance_fold", "filtered_probs_torch", "pow2_width"]
