"""Models of the port: the Llama, GPT and Mixtral families (Llama and
GPT with their training forward; every family served through the decode
bundles of ``generation``), BERT, DiT and Qwen-VL (built from ``nn``'s
layers), and the bridge that copies a JAX-package model's parameters
and an optimizer's state in and out."""
from . import bert, dit, qwen_vl  # noqa: F401
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .bridge import (export_buffers, export_optimizer_state,
                     export_params, load_jax_params, load_optimizer_state)
from .dit import (DiT, DiTConfig, DiTForDiffusion, dit_s_4,  # noqa: F401
                  dit_tiny)
from .gpt import GPTConfig, GPTForCausalLM, gpt2_345m, gpt2_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama2_7b,
                    llama2_70b, llama_350m, llama_tiny)
from .mixtral import (MixtralConfig, MixtralForCausalLM, mixtral_8x7b,
                      mixtral_tiny, moe_350m_8e)
from .qwen_vl import (QwenVL, QwenVLConfig, ViTConfig,  # noqa: F401
                      VisionTransformer, qwen_vl_tiny)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama2_7b",
           "llama2_70b", "llama_350m", "llama_tiny", "GPTConfig",
           "GPTForCausalLM", "gpt2_345m", "gpt2_tiny", "MixtralConfig",
           "MixtralForCausalLM", "mixtral_8x7b", "moe_350m_8e",
           "mixtral_tiny", "BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_tiny",
           "DiTConfig", "DiT", "DiTForDiffusion", "dit_s_4", "dit_tiny",
           "ViTConfig", "VisionTransformer", "QwenVLConfig", "QwenVL",
           "qwen_vl_tiny", "load_jax_params", "export_params",
           "export_buffers", "export_optimizer_state", "load_optimizer_state"]
