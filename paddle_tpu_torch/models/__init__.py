"""Models of the port: the Llama family (training forward and paged
serving), and the bridge that copies a JAX-package model's parameters
and an optimizer's state in and out."""
from .bridge import (export_optimizer_state, export_params,
                     load_jax_params, load_optimizer_state)
from .llama import (LlamaConfig, LlamaForCausalLM, llama2_7b, llama2_70b,
                    llama_350m, llama_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama2_7b", "llama2_70b",
           "llama_350m", "llama_tiny", "load_jax_params",
           "export_params", "export_optimizer_state", "load_optimizer_state"]
