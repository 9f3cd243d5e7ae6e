"""Baseline attention implementations (benchmark comparison kernels).

Mirrors the role of `/root/reference/src/other_implementations/
flex_attention.py:14-26` — a third-party implementation used purely for
benchmark comparisons, never as the numerics oracle (that is
`fa2_jax.ops.reference`).
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp


def xla_attention(
    q: jax.Array,  # [B, Sq, Hq, D]
    k: jax.Array,  # [B, Sk, Hkv, D]
    v: jax.Array,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
) -> jax.Array:
    """Dense, unfused attention as XLA compiles it from idiomatic jnp code.

    Chunked over heads with `lax.map` (rematerialized under AD) so the full
    [B, H, Sq, Sk] fp32 score tensor never materializes at long sequence
    lengths; each per-head step still writes its scores to device memory.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kr = jnp.repeat(k, Hq // Hkv, axis=2)
    vr = jnp.repeat(v, Hq // Hkv, axis=2)
    qs = jnp.moveaxis(q, 2, 0) * scale  # [H, B, S, D]

    @jax.checkpoint
    def one_head(args):
        qh, kh, vh = args  # [B, S, D]
        s = jnp.einsum("btd,bsd->bts", qh, kh)
        if causal:
            mask = jnp.tril(jnp.ones((Sq, Sk), bool), k=Sk - Sq)
            s = jnp.where(mask, s, -jnp.inf)
        p = jax.nn.softmax(s.astype(jnp.float32), axis=-1).astype(vh.dtype)
        return jnp.einsum("bts,bsd->btd", p, vh)

    o = jax.lax.map(one_head, (qs, jnp.moveaxis(kr, 2, 0), jnp.moveaxis(vr, 2, 0)))
    return jnp.moveaxis(o, 0, 2)


def cudnn_attention(
    q: jax.Array,  # [B, Sq, Hq, D]
    k: jax.Array,  # [B, Sk, Hkv, D]
    v: jax.Array,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
) -> jax.Array:
    """cuDNN's fused flash attention, through
    `jax.nn.dot_product_attention(implementation="cudnn")` — the library
    kernel the hand-written one is compared against on the GPU. Takes the
    same BSHD layout and GQA head counts; bf16/fp16 inputs only (cuDNN's
    constraint), and it raises on a backend without cuDNN."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    return jax.nn.dot_product_attention(
        q, k, v, scale=scale, is_causal=causal, implementation="cudnn")
