"""Pure-JAX attention oracle — the framework's ground truth.

Reproduces the semantics of the reference PyTorch oracle
(`/root/reference/src/reference_implementation.py:38-123`): GQA via head
repetition, pre-softmax scaling, tanh softcapping, key-padding masks,
sliding-window (local) masks with bottom-right-aligned causal offsets,
additive broadcastable bias, externally-supplied dropout masks, zero-fill of
fully-masked rows, and the `upcast` / `reorder_ops` knobs used by the
relative-tolerance test harness to establish an error yardstick.

Everything here is plain jnp on any backend; the Pallas kernels are validated
against this oracle.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fa2_jax.utils import LOG2E


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size: Tuple[int, int] = (-1, -1),
    query_padding_mask: Optional[jax.Array] = None,
    key_padding_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Boolean mask (True = MASKED OUT) broadcastable to [B, 1, Sq, Sk].

    Bottom-right aligned: the causal/window diagonal runs through the last
    valid key of each sequence, using per-batch *actual* lengths when padding
    masks are given (reference `construct_local_mask`, lines 8-35).
    """
    row_idx = jnp.arange(seqlen_q, dtype=jnp.int32).reshape(seqlen_q, 1)
    col_idx = jnp.arange(seqlen_k, dtype=jnp.int32)
    if key_padding_mask is None:
        sk = jnp.int32(seqlen_k)
    else:
        sk = key_padding_mask.sum(-1).astype(jnp.int32).reshape(-1, 1, 1, 1)
    if query_padding_mask is None:
        sq = jnp.int32(seqlen_q)
    else:
        sq = query_padding_mask.sum(-1).astype(jnp.int32).reshape(-1, 1, 1, 1)
    # -1 means INFINITE on that side (the kernel/API contract). The
    # reference oracle (`reference_implementation.py:8-35`) substitutes a
    # literal -1 into the right bound when left >= 0 — a latent quirk its
    # grid never exercises (it only passes (-1,-1) or (w, 0)); ours does.
    if window_size[0] < 0 and window_size[1] < 0:
        return jnp.zeros((seqlen_q, seqlen_k), bool)
    if window_size[0] < 0:
        return col_idx > row_idx + sk - sq + window_size[1]
    if window_size[1] < 0:
        return col_idx < row_idx + sk - sq - window_size[0]
    return jnp.logical_or(
        col_idx > jnp.minimum(row_idx + sk - sq + window_size[1], sk),
        col_idx < row_idx + sk - sq - window_size[0],
    )


def flash_attn_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    query_padding_mask: Optional[jax.Array] = None,
    key_padding_mask: Optional[jax.Array] = None,
    attn_bias: Optional[jax.Array] = None,
    dropout_p: float = 0.0,
    dropout_mask: Optional[jax.Array] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    reorder_ops: bool = False,
    return_lse: bool = False,
):
    """Ground-truth attention.

    Args:
        q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq % Hkv == 0.
        query_padding_mask / key_padding_mask: bool [B, Sq] / [B, Sk].
        attn_bias: additive, broadcastable to [B, Hq, Sq, Sk].
        dropout_mask: bool keep-mask [B, Hq, Sq, Sk] (True = keep).
        causal: bottom-right aligned causal masking.
        window_size: (left, right) sliding window; -1 = infinite.
        softcap: if > 0, scores = softcap * tanh(scores / softcap).
        upcast: compute in fp32 and cast back at the end.
        reorder_ops: scale K instead of Q (error-yardstick variant).
        return_lse: also return the base-2 logsumexp [B, Hq, Sq]
            (natural-log LSE times log2(e) — the kernels' stored unit).

    Returns:
        output [B, Sq, Hq, D], and optionally lse [B, Hq, Sq].
    """
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32)
        if attn_bias is not None:
            attn_bias = attn_bias.astype(jnp.float32)
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    repeats = q.shape[2] // k.shape[2]
    k = jnp.repeat(k, repeats, axis=2)
    v = jnp.repeat(v, repeats, axis=2)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    # On the GPU, fp32 einsums default to TF32 tensor-core matmuls; the
    # upcast oracle must be TRUE fp32 to serve as ground truth, while the
    # low-precision yardstick variant keeps the backend default (mirroring
    # the reference's "PyTorch low-precision" comparison point).
    prec = jax.lax.Precision.HIGHEST if upcast else jax.lax.Precision.DEFAULT
    if not reorder_ops:
        scores = jnp.einsum("bthd,bshd->bhts", q * scale, k, precision=prec)
    else:
        scores = jnp.einsum("bthd,bshd->bhts", q, k * scale, precision=prec)
    if softcap > 0:
        scores = jnp.tanh(scores / softcap) * softcap
    if key_padding_mask is not None:
        scores = jnp.where(
            (~key_padding_mask.astype(bool)).reshape(key_padding_mask.shape[0], 1, 1, seqlen_k),
            -jnp.inf,
            scores,
        )
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, query_padding_mask, key_padding_mask
        )
        scores = jnp.where(local_mask, -jnp.inf, scores)
    if attn_bias is not None:
        scores = scores + attn_bias

    row_max = jnp.max(scores, axis=-1, keepdims=True)
    row_max_safe = jnp.where(jnp.isinf(row_max), 0.0, row_max)
    unnorm = jnp.exp(scores - row_max_safe)
    unnorm = jnp.where(jnp.isinf(scores) & (scores < 0), 0.0, unnorm)
    denom = jnp.sum(unnorm, axis=-1, keepdims=True)
    attention = unnorm / jnp.maximum(denom, jnp.finfo(unnorm.dtype).tiny)
    lse = (row_max_safe + jnp.log(jnp.maximum(denom, 0.0)))[..., 0] * LOG2E

    attention = attention.astype(v.dtype)
    # Zero fully-masked rows so they produce 0 output, not NaN.
    if local_mask is not None:
        attention = jnp.where(jnp.all(local_mask, axis=-1, keepdims=True), 0.0, attention)
    if query_padding_mask is not None:
        qmask = (~query_padding_mask.astype(bool)).reshape(q.shape[0], 1, seqlen_q, 1)
        attention = jnp.where(qmask, 0.0, attention)
    dropout_scaling = 1.0 / (1.0 - dropout_p)
    if dropout_mask is not None:
        attention_drop = jnp.where(dropout_mask, attention, 0.0)
    else:
        attention_drop = attention
    output = jnp.einsum("bhts,bshd->bthd", attention_drop, v * dropout_scaling,
                        precision=prec)
    if query_padding_mask is not None:
        qmask_o = (~query_padding_mask.astype(bool)).reshape(q.shape[0], seqlen_q, 1, 1)
        output = jnp.where(qmask_o, 0.0, output)
    output = output.astype(dtype_og)
    if return_lse:
        return output, lse
    return output
