"""Models of the port: the Llama, GPT and Mixtral families (Llama and
GPT with their training forward; every family served through the decode
bundles of ``generation``), and the bridge that copies a JAX-package
model's parameters and an optimizer's state in and out."""
from .bridge import (export_optimizer_state, export_params,
                     load_jax_params, load_optimizer_state)
from .gpt import GPTConfig, GPTForCausalLM, gpt2_345m, gpt2_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, llama2_7b, llama2_70b,
                    llama_350m, llama_tiny)
from .mixtral import (MixtralConfig, MixtralForCausalLM, mixtral_8x7b,
                      mixtral_tiny, moe_350m_8e)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama2_7b", "llama2_70b",
           "llama_350m", "llama_tiny", "GPTConfig", "GPTForCausalLM",
           "gpt2_345m", "gpt2_tiny", "MixtralConfig", "MixtralForCausalLM",
           "mixtral_8x7b", "moe_350m_8e", "mixtral_tiny", "load_jax_params",
           "export_params", "export_optimizer_state", "load_optimizer_state"]
