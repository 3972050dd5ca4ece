from .gpt import GPTConfig, GPTForCausalLM, gpt3_1p3b, gpt_tiny
from .llama import LlamaConfig, LlamaForCausalLM, llama2_7b, llama_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "gpt3_1p3b", "gpt_tiny", "llama2_7b", "llama_tiny"]
