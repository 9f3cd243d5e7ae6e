from fa2_jax.parallel.mesh import (
    AXIS_DATA,
    fsdp_param_pspecs,
    AXIS_MODEL,
    AXIS_SEQ,
    make_mesh,
    param_pspecs,
    shard_params,
)
from fa2_jax.parallel.attention import make_tp_attention
from fa2_jax.parallel.mesh import AXIS_PIPE
from fa2_jax.parallel.pipeline import (
    make_llama_3d_forward,
    make_llama_pipeline_forward,
    make_pipeline,
    pipeline_params_from_llama,
)
from fa2_jax.parallel.ring import make_ring_attention, ring_attention_local
from fa2_jax.parallel.ulysses import make_ulysses_attention

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "AXIS_PIPE", "AXIS_SEQ",
    "make_mesh", "param_pspecs", "shard_params", "fsdp_param_pspecs",
    "make_tp_attention", "make_ring_attention", "ring_attention_local",
    "make_ulysses_attention",
    "make_pipeline", "make_llama_pipeline_forward", "make_llama_3d_forward",
    "pipeline_params_from_llama",
]
