"""Speculative-decoding configuration. Counterpart of
paddle_tpu/inference/speculative/config.py (copied: the port imports
nothing of the JAX package).

One declarative object selects the proposer family and its knobs; the
serving sessions build the per-session proposer state (a draft model's
paged pools, the host rng) from it. Declarative-by-design: the SAME
config can key an ``aot_generate`` session-cache entry (``cache_key``)
without dragging device state into the key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class SpeculativeConfig:
    """Knobs for the proposer/verifier subsystem.

    num_draft_tokens  max draft tokens proposed per verified step (k);
                      each accepted step emits between 1 and k+1 tokens
    proposer          "ngram": prompt-lookup self-drafting from the
                      request's own token history (no extra weights) —
                      vLLM's prompt-lookup / [ngram] method;
                      "draft": a smaller causal LM proposes greedily
                      through its own kv-heads-sized paged-KV pool
    ngram_max/_min    longest/shortest suffix n-gram tried for the
                      history match (ngram proposer only)
    draft_model       the proposer model for proposer="draft" — anything
                      ``get_model_adapter`` accepts (GPT or Llama)
    seed              seed of the acceptance draws: the continuous
                      session's Philox generator of the verify windows'
                      uniforms, the batch session's host rng (sampled
                      decoding only decides by them)
    """

    num_draft_tokens: int = 4
    proposer: str = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1
    draft_model: Optional[Any] = None
    seed: int = 0

    def __post_init__(self):
        if self.proposer not in ("ngram", "draft"):
            raise ValueError(
                f"proposer must be 'ngram' or 'draft'; got "
                f"{self.proposer!r}")
        if self.num_draft_tokens < 1:
            raise ValueError("num_draft_tokens must be >= 1")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        if self.proposer == "draft" and self.draft_model is None:
            raise ValueError("proposer='draft' needs draft_model")

    def cache_key(self):
        """Hashable identity for executable/session caches. The draft
        model keys by object identity: two configs around the same
        model object share compiled sessions; a different draft model
        (even same-shaped) never does."""
        return (self.proposer, self.num_draft_tokens, self.ngram_max,
                self.ngram_min,
                None if self.draft_model is None else id(self.draft_model),
                self.seed)


def resolve_speculative(speculative) -> Optional[SpeculativeConfig]:
    """None / SpeculativeConfig / kwargs-dict -> SpeculativeConfig."""
    if speculative is None or isinstance(speculative, SpeculativeConfig):
        return speculative
    if isinstance(speculative, dict):
        return SpeculativeConfig(**speculative)
    raise TypeError(
        f"speculative must be a SpeculativeConfig, a kwargs dict, or "
        f"None; got {type(speculative).__name__}")
