"""Counter-based RNG for dropout, shared by the Pallas kernels and the oracle.

The reference makes Philox dropout testable by re-generating the exact
`tl.rand` stream in a second Triton kernel and handing the resulting boolean
mask to the PyTorch oracle (`tests/utils.py:169-207`). The design here
is simpler: dropout bits come from a *pure-jnp integer hash* over the global
(batch, head, q_position, kv_position) counter. The very same jnp ops run

  * inside the Pallas kernel (on `broadcasted_iota` offsets), and
  * in the pure-JAX oracle (on a dense offset grid),

so kernel and oracle consume bit-identical masks on every backend (GPU
compiled, CPU interpret) with no stream-replication kernel needed. The hash is
a two-round xorshift-multiply mixer (lowbias32-style avalanche), statistically
ample for dropout.
"""
from __future__ import annotations

import jax.numpy as jnp


def counter_hash_uint32(seed, counter):
    """Mix a uint32 counter with a seed into well-distributed uint32 bits.

    Both arguments may be scalars or arrays (broadcastable). All arithmetic
    wraps mod 2**32, identically under Pallas/Triton, XLA:CPU and XLA:GPU.
    """
    x = counter.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    x = x + seed.astype(jnp.uint32) if hasattr(seed, "astype") else x + jnp.uint32(seed)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x735A2D97)
    x = x ^ (x >> 15)
    return x


def dropout_threshold(dropout_p: float) -> int:
    """uint32 threshold: an element is DROPPED iff hash < threshold."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def dropout_offsets(batch, nheads, seqlen_q, seqlen_k):
    """Dense uint32 counter grid [B, H, Sq, Sk] for the oracle-side mask."""
    b = jnp.arange(batch, dtype=jnp.uint32).reshape(-1, 1, 1, 1)
    h = jnp.arange(nheads, dtype=jnp.uint32).reshape(1, -1, 1, 1)
    i = jnp.arange(seqlen_q, dtype=jnp.uint32).reshape(1, 1, -1, 1)
    j = jnp.arange(seqlen_k, dtype=jnp.uint32).reshape(1, 1, 1, -1)
    sk = jnp.uint32(seqlen_k)
    sq = jnp.uint32(seqlen_q)
    nh = jnp.uint32(nheads)
    return ((b * nh + h) * sq + i) * sk + j


def dropout_keep_mask_reference(seed: int, dropout_p: float, batch: int,
                                nheads: int, seqlen_q: int, seqlen_k: int):
    """Boolean keep-mask [B, H, Sq, Sk], bit-identical to the kernels' mask."""
    offs = dropout_offsets(batch, nheads, seqlen_q, seqlen_k)
    bits = counter_hash_uint32(jnp.uint32(seed), offs)
    return bits >= jnp.uint32(dropout_threshold(dropout_p))
