"""Flax linen integration layer.

The reference is a bare kernel library — users wire `flash_attn_func` into
their own modules (`/root/reference/src/wrapper.py:89-100` is the whole user
surface). On the JAX side most model code is written against `flax.linen`,
so this module provides a drop-in attention layer that routes through the
Pallas kernels: projections + GQA head layout + optional rotary embeddings
around `flash_attn_func`, with flax-idiomatic dropout RNG plumbing
(`self.make_rng("dropout")` feeds the kernel's counter-based stream, so the
raise-if-seedless contract of `ops/attention.py` is satisfied per call).

Purely additive surface: models/ stays functional (pytree params), this is
for users embedding the kernels in existing linen codebases.
"""
from __future__ import annotations

from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from fa2_jax.models.llama import apply_rope, rope_cos_sin
from fa2_jax.ops.attention import flash_attn_func


class FlashSelfAttention(nn.Module):
    """Multi-head (optionally grouped-query) self-attention on the flash
    kernels.

    Input/output: [batch, seqlen, features]. Head layout, GQA grouping and
    masking semantics match `flash_attn_func` (`ops/attention.py`): the
    optional `mask` is a [batch, seqlen] right-padding mask (True = valid)
    applied to both queries and keys.
    """

    num_heads: int
    num_kv_heads: Optional[int] = None       # GQA/MQA; defaults to num_heads
    head_dim: Optional[int] = None           # defaults to features // num_heads
    causal: bool = False
    dropout_p: float = 0.0
    window_size: Tuple[int, int] = (-1, -1)  # sliding window, -1 = infinite
    softcap: float = 0.0
    use_rope: bool = False
    rope_theta: float = 10000.0
    dtype: Optional[jnp.dtype] = None        # compute/activation dtype
    param_dtype: jnp.dtype = jnp.float32
    use_bias: bool = False                   # bias on the projections

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        mask: Optional[jax.Array] = None,
        bias: Optional[jax.Array] = None,
        *,
        deterministic: bool = True,
    ) -> jax.Array:
        B, S, F = x.shape
        n_kv = self.num_kv_heads or self.num_heads
        assert self.num_heads % n_kv == 0, (self.num_heads, n_kv)
        hd = self.head_dim or F // self.num_heads
        dense = lambda feats, name: nn.DenseGeneral(  # noqa: E731
            features=feats, axis=-1, use_bias=self.use_bias, name=name,
            dtype=self.dtype, param_dtype=self.param_dtype,
        )

        q = dense((self.num_heads, hd), "q_proj")(x)
        k = dense((n_kv, hd), "k_proj")(x)
        v = dense((n_kv, hd), "v_proj")(x)

        if self.use_rope:
            cos, sin = rope_cos_sin(jnp.arange(S), hd, self.rope_theta)
            cos, sin = (c[None, :, None, :] for c in (cos, sin))  # [1,S,1,hd/2]
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        p = 0.0 if deterministic else self.dropout_p
        rng = self.make_rng("dropout") if p > 0.0 else None
        out = flash_attn_func(
            q, k, v,
            attention_mask=mask,
            attention_bias=bias,
            dropout_p=p,
            causal=self.causal,
            window_size=self.window_size,
            softcap=self.softcap,
            dropout_rng=rng,
        )
        out = out.reshape(B, S, self.num_heads * hd)
        return dense(F, "o_proj")(out)
