"""Llama with recompute (``LlamaConfig(recompute=True)``) against the JAX
package's: test_torch_recompute.py's GPT check for llama_tiny's width at
GQA 4:2 (d=32: the plain K4/K5 on the CPU), in a file of its own so that
each file builds one JAX model. Tolerances as there: 1e-5 relative
against JAX, equal bytes against the port without recompute."""
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama

from test_torch_recompute import LLAMA, check_against_jax


def test_llama_recompute_matches_jax_and_equals_no_recompute():
    paddle.seed(11)
    check_against_jax("llama", JLlama(JLlamaConfig(**LLAMA, recompute=True)))
