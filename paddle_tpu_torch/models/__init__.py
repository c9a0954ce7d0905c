from .convert import (hybrid_state_from_jax, jax_trainer_arrays,
                      layer_state_from_jax, state_dict_from_jax)
from .generation import generate
from .gpt_moe import GPTMoEConfig, GPTMoEForCausalLM, gpt_moe_tiny
from .gpt import (GPTBlock, GPTConfig, GPTForCausalLM, GPTModel, gpt3_6_7b,
                  gpt_small, gpt_tiny)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel, llama_7b, llama_tiny)
from .trainer import GPTHybridTrainer, GPTMoEHybridTrainer

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "GPTHybridTrainer", "GPTMoEHybridTrainer", "GPTMoEConfig",
           "GPTMoEForCausalLM", "gpt_moe_tiny", "LlamaConfig",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM", "gpt_tiny", "gpt_small",
           "gpt3_6_7b", "llama_tiny", "llama_7b", "generate",
           "state_dict_from_jax", "layer_state_from_jax",
           "jax_trainer_arrays",
           "hybrid_state_from_jax"]
