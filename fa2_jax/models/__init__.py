from fa2_jax.models import gpt2
from fa2_jax.models.llama import (
    LlamaConfig,
    init_params,
    forward,
    loss_fn,
    init_kv_cache,
    forward_with_cache,
    llama31_8b,
)
from fa2_jax.models.gpt2 import GPT2Config
from fa2_jax.models import convert, lora, moe
from fa2_jax.models.moe import MoEConfig

__all__ = [
    "LlamaConfig", "init_params", "forward", "loss_fn",
    "init_kv_cache", "forward_with_cache", "llama31_8b", "GPT2Config", "gpt2",
    "moe", "MoEConfig", "lora", "convert",
]
