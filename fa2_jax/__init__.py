"""fa2_jax — a FlashAttention-2 framework in JAX (Pallas, Triton route).

Brand-new JAX/Pallas implementation with the capabilities of
remi-or/fa2_triton (FlashAttention-2 forward/backward kernels with causal,
GQA/MQA, varlen, bias, dropout and deterministic execution), extended with
quantized KV-cache attention, a continuous-batching decode runtime, and
multi-device sharding (tensor-parallel heads, ring sequence parallelism).

Public API mirrors the reference (`/root/reference/src/__init__.py:1-4`).
"""

from fa2_jax.ops import (
    flash_attn_func,
    flash_attn_reference,
    flash_attn_blocksparse_func,
    flash_attn_varlen_func,
    pack_padded_batch,
    unpack_padded_batch,
)

def __getattr__(name):
    # Lazy: the linen layer pulls in flax, which plain kernel users may not
    # want on the import path.
    if name == "FlashSelfAttention":
        from fa2_jax.layers import FlashSelfAttention

        return FlashSelfAttention
    raise AttributeError(name)


__all__ = [
    "FlashSelfAttention",
    "flash_attn_func",
    "flash_attn_reference",
    "flash_attn_varlen_func",
    "flash_attn_blocksparse_func",
    "pack_padded_batch",
    "unpack_padded_batch",
]
__version__ = "0.1.0"
