from fa2_jax.utils.common import (
    cdiv,
    round_up_to_multiple,
    next_power_of_2,
    pad_to_multiple,
    default_softmax_scale,
    head_dim_padded,
    use_interpreter,
    kernel_call,
    enable_compile_cache,
    dot_precision,
    LOG2E,
    NEG_INF,
    MASK_VALUE,
)
from fa2_jax.utils.rng import (
    counter_hash_uint32,
    dropout_keep_mask_reference,
    dropout_threshold,
)

__all__ = [
    "cdiv",
    "round_up_to_multiple",
    "next_power_of_2",
    "pad_to_multiple",
    "default_softmax_scale",
    "head_dim_padded",
    "use_interpreter",
    "kernel_call",
    "enable_compile_cache",
    "dot_precision",
    "LOG2E",
    "NEG_INF",
    "MASK_VALUE",
    "counter_hash_uint32",
    "dropout_keep_mask_reference",
    "dropout_threshold",
]

