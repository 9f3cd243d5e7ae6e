from fa2_jax.ops.attention import flash_attn_func, AttnConfig
from fa2_jax.ops.reference import flash_attn_reference, construct_local_mask
from fa2_jax.ops.tuning import BlockSizes, choose_block_sizes
from fa2_jax.ops.varlen import (
    flash_attn_blocksparse_func, flash_attn_varlen_func, pack_padded_batch,
    unpack_padded_batch,
)

__all__ = [
    "flash_attn_func",
    "flash_attn_reference",
    "construct_local_mask",
    "AttnConfig",
    "BlockSizes",
    "choose_block_sizes",
    "flash_attn_varlen_func",
    "flash_attn_blocksparse_func",
    "pack_padded_batch",
    "unpack_padded_batch",
]
