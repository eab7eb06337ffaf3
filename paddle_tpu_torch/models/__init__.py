"""Models of the port: the Llama family for paged serving, and the
bridge that copies a JAX-package model's parameters in."""
from .bridge import load_jax_params
from .llama import (LlamaConfig, LlamaForCausalLM, llama2_7b, llama2_70b,
                    llama_350m, llama_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama2_7b", "llama2_70b",
           "llama_350m", "llama_tiny", "load_jax_params"]
