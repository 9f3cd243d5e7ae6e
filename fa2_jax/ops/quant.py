"""KV-cache quantization (INT8 / FP8 storage, fused in-kernel dequant).

North-star extension (BASELINE.json): the KV cache is stored quantized in
HBM — per (token, head) symmetric scales — and dequantized INSIDE the
attention kernels' register tiles (`ops/decode.py`), never materialized in HBM.
Decode attention is HBM-bandwidth-bound, so int8 storage is ~2x decode
throughput over bf16 at matched batch.

Scale granularity: per (token, kv_head), amax over the head dim — the
column-scale factors commute with the QK^T contraction exactly, so parity
tests can pin the math at matched bit-width.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn


def quantize_tensor(x: jax.Array, qdtype) -> Tuple[jax.Array, jax.Array]:
    """Quantize [..., D] to qdtype with per-[...] (amax over D) scales.

    Returns (values [..., D] qdtype, scales [..., 1] fp32) with
    x ~= values * scales.
    """
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    qmax = INT8_MAX if qdtype == jnp.int8 else FP8_MAX
    scale = jnp.where(amax > 0, amax / qmax, 1.0)
    scaled = xf / scale
    if qdtype == jnp.int8:
        vals = jnp.clip(jnp.round(scaled), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    else:
        vals = scaled.astype(qdtype)
    return vals, scale


def dequantize_tensor(vals: jax.Array, scales: jax.Array, dtype=jnp.float32):
    return (vals.astype(jnp.float32) * scales).astype(dtype)


def quantize_kv(k: jax.Array, v: jax.Array, qdtype=jnp.int8):
    """Quantize K/V [B, S, H, D] -> ((kq, ks), (vq, vs))."""
    kq, ks = quantize_tensor(k, qdtype)
    vq, vs = quantize_tensor(v, qdtype)
    return (kq, ks), (vq, vs)


# ----------------------- weight-only quantization -------------------------

def quantize_weight(w: jax.Array, qdtype=jnp.int8) -> dict:
    """Weight-only quantization of a [in, out] matrix with per-OUTPUT-channel
    scales. The matmul dequant fuses into the epilogue:
    x @ (wq * s_out) == (x @ wq) * s_out."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0, keepdims=True)          # [1, out]
    qmax = INT8_MAX if qdtype == jnp.int8 else FP8_MAX
    scale = jnp.where(amax > 0, amax / qmax, 1.0)
    scaled = wf / scale
    if qdtype == jnp.int8:
        vals = jnp.clip(jnp.round(scaled), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    else:
        vals = scaled.astype(qdtype)
    return {"qvalues": vals, "qscale": scale.astype(jnp.float32)}


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and "qvalues" in w


def qmatmul(x: jax.Array, w) -> jax.Array:
    """x @ w for plain or weight-only-quantized w (dequant in the epilogue)."""
    if is_quantized_weight(w):
        y = jnp.dot(x, w["qvalues"].astype(x.dtype),
                    preferred_element_type=jnp.float32)
        return (y * w["qscale"]).astype(x.dtype)
    return x @ w
