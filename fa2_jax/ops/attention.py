"""Public flash-attention API: `flash_attn_func`.

The JAX counterpart of the reference's autograd layer
(`/root/reference/src/wrapper.py`): `torch.autograd.Function` becomes
`jax.custom_vjp`; the forward saves (q, k, v, bias, o, lse) as residuals and
the backward recomputes attention from the base-2 LSE (SURVEY.md §2.2).

Host-side prep replaces the reference caller logic
(`src/forward/caller.py:12-122`, `src/backward/caller.py:14-178`): instead of
physically packing variable-length batches and masking per-element loads, we

* transpose BSHD -> BHSD (each program reads contiguous [block, D] tiles),
* zero-pad the head dim to a power of two, at least 16, like the reference
  (`src/forward/caller.py:77-78`),
* zero-pad sequence lengths to block multiples, and
* carry per-batch actual lengths [B, 2] into the kernels, which mask
  positionally (right-padding varlen without packing).

All padding/slicing lives *outside* the `custom_vjp` core, so XLA's transpose
rules pad/slice the cotangents automatically and the core works on aligned
tiles only.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax.ops.flash_bwd import flash_attn_backward
from fa2_jax.ops.flash_fwd import flash_attn_forward
from fa2_jax.ops.tuning import BlockSizes, choose_block_sizes
from fa2_jax.utils import (
    default_softmax_scale,
    head_dim_padded,
    pad_to_multiple,
)


@dataclass(frozen=True)
class AttnConfig:
    causal: bool
    softmax_scale: float
    window: Tuple[int, int]
    softcap: float
    dropout_p: float
    blocks: BlockSizes
    seqlen_q_real: int
    seqlen_k_real: int


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _attn_core(cfg: AttnConfig, q, k, v, bias, lens, scalars):
    (o, lse), _ = _attn_core_fwd(cfg, q, k, v, bias, lens, scalars)
    return o, lse


def _attn_core_fwd(cfg: AttnConfig, q, k, v, bias, lens, scalars):
    o, lse = flash_attn_forward(
        q, k, v, lens, scalars, bias,
        causal=cfg.causal,
        softmax_scale=cfg.softmax_scale,
        window=cfg.window,
        softcap=cfg.softcap,
        dropout_p=cfg.dropout_p,
        seqlen_q_real=cfg.seqlen_q_real,
        seqlen_k_real=cfg.seqlen_k_real,
        block_q=cfg.blocks.block_q,
        block_kv=cfg.blocks.block_kv,
        num_warps=cfg.blocks.num_warps,
        num_stages=cfg.blocks.num_stages,
    )
    return (o, lse), (q, k, v, bias, lens, scalars, o, lse)


def _attn_core_bwd(cfg: AttnConfig, res, cot):
    q, k, v, bias, lens, scalars, o, lse = res
    # Both outputs are differentiated: do is the output cotangent, dlse the
    # logsumexp cotangent (folded into the delta row statistic inside
    # flash_attn_backward — the reference drops it, its LSE is test-only).
    do, dlse = cot
    grads = flash_attn_backward(
        q, k, v, do, o, lse, lens, scalars, bias,
        causal=cfg.causal,
        softmax_scale=cfg.softmax_scale,
        window=cfg.window,
        softcap=cfg.softcap,
        dropout_p=cfg.dropout_p,
        seqlen_q_real=cfg.seqlen_q_real,
        seqlen_k_real=cfg.seqlen_k_real,
        dlse=dlse,
        compute_dbias=bias is not None,
        block_q=cfg.blocks.block_q_bwd,
        block_kv=cfg.blocks.block_kv_bwd,
        num_warps=cfg.blocks.num_warps_bwd,
        num_stages=cfg.blocks.num_stages_bwd,
    )
    if bias is None:
        dq, dk, dv = grads
        dbias = None
    else:
        # Real bias gradient (the reference returns None at
        # `src/wrapper.py:86`; a trainable bias there silently gets no grad).
        dq, dk, dv, dbias = grads
    int_zero = lambda x: np.zeros(x.shape, dtype=jax.dtypes.float0)
    return dq, dk, dv, dbias, int_zero(lens), int_zero(scalars)


_attn_core.defvjp(_attn_core_fwd, _attn_core_bwd)


def _to_bhsd(x):
    return jnp.transpose(x, (0, 2, 1, 3))


def flash_attn_func(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    attention_mask: Optional[jax.Array] = None,
    attention_bias: Optional[jax.Array] = None,
    dropout_p: float = 0.0,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    dropout_seed: Optional[int] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    dropout_rng: Optional[jax.Array] = None,
    fp16_compute_dtype: Optional[jnp.dtype] = None,
):
    """FlashAttention-2 (Pallas, Triton route), differentiable via `jax.custom_vjp`.

    Mirrors the reference public API (`src/wrapper.py:89-100`), with the
    reference's oracle-only features (sliding window, softcap) supported in
    the kernels as well, plus dropout in the backward pass (the reference
    raises for backward+dropout, `src/utils.py:88`).

    Args:
        q: [batch, seqlen_q, num_heads_q, head_dim].
        k, v: [batch, seqlen_k, num_heads_kv, head_dim]; num_heads_q must be
            a multiple of num_heads_kv (GQA/MQA).
        attention_mask: optional bool [batch, seqlen_q] right-padding mask
            (True = valid). Requires seqlen_q == seqlen_k; applied to both
            queries and keys, like the reference (`src/forward/caller.py:27`).
        attention_bias: optional additive bias broadcastable to
            [batch, num_heads_q, seqlen_q, seqlen_k].
        dropout_p: attention dropout probability (counter-based RNG; see
            `fa2_jax/utils/rng.py` for the oracle-replicable stream).
        causal: bottom-right-aligned causal masking.
        softmax_scale: defaults to 1/sqrt(head_dim).
        dropout_seed: int seed for the dropout stream. When dropout_p > 0,
            exactly one of dropout_seed / dropout_rng must be given — the
            reference draws a fresh random seed per call
            (`src/utils.py:86`), which a pure function cannot, so silently
            defaulting to a fixed seed (same mask every layer and step)
            would be a correctness trap.
        dropout_rng: alternatively, a `jax.random` key the seed is derived
            from (fold a per-step/per-layer key in training loops).
        window_size: (left, right) sliding window, -1 = infinite.
        softcap: if > 0, scores are softcap * tanh(scores / softcap).
        block_sizes: optional BlockSizes override.
        return_lse: also return the logsumexp [batch, num_heads_q, seqlen_q]
            in log-base-2 units, fp32 (kernel LSE contract, SURVEY.md §2.2).
        fp16_compute_dtype: for float16 inputs only — the dtype the kernels
            compute in. Default float32 (precise, fp16 runs at fp32 speed);
            jnp.bfloat16 opts into full-rate tensor-core compute at
            reference-comparable low precision.

    Returns:
        output [batch, seqlen_q, num_heads_q, head_dim] (and lse if requested).
    """
    out_dtype = q.dtype
    if q.dtype == jnp.float16:
        # fp16 I/O (which the reference's whole test grid uses,
        # `/root/reference/tests/test_fwd_bwd.py:13`) is honored at the API
        # boundary: by default the kernels compute in f32 (strictly more
        # precise than fp16-native arithmetic, so the FA tolerance contract
        # holds) and the output is cast back. Users who want bf16-tier speed
        # at reference-comparable (low) precision can opt in with
        # fp16_compute_dtype=jnp.bfloat16 (bf16 has fp16's 2^-8-level
        # mantissa error profile but wider exponent — no overflow hazard).
        cd = jnp.float32 if fp16_compute_dtype is None else fp16_compute_dtype
        assert cd in (jnp.float32, jnp.bfloat16), \
            "fp16_compute_dtype must be float32 (precise) or bfloat16 (fast)"
        q, k, v = (x.astype(cd) for x in (q, k, v))
        if attention_bias is not None and attention_bias.dtype == jnp.float16:
            attention_bias = attention_bias.astype(jnp.float32)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    assert D == Dk and v.shape == k.shape and Bk == B
    assert Hq % Hkv == 0, "num_heads_q must be a multiple of num_heads_kv"
    if attention_mask is not None:
        assert Sq == Sk, "attention_mask requires seqlen_q == seqlen_k"
        assert attention_mask.shape == (B, Sq)
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(D)

    Dp = head_dim_padded(D)
    blocks = block_sizes or choose_block_sizes(
        Sq, Sk, Dp,
        # Post-cast dtype: fp16's default f32 compute means the kernels see
        # f32 I/O, which gets narrower blocks.
        dtype_bits=q.dtype.itemsize * 8,
    )
    pad_q, pad_kv = blocks.q_multiple, blocks.kv_multiple
    qT = pad_to_multiple(pad_to_multiple(_to_bhsd(q), pad_q, 2), Dp, 3)
    kT = pad_to_multiple(pad_to_multiple(_to_bhsd(k), pad_kv, 2), Dp, 3)
    vT = pad_to_multiple(pad_to_multiple(_to_bhsd(v), pad_kv, 2), Dp, 3)

    bias_p = None
    if attention_bias is not None:
        # Keep the bias in its own dtype (the kernels upcast per tile); only
        # the seq dims are materialized — batch/head broadcasting stays
        # broadcast, and the dbias pass reduces back over those dims.
        bias_p = jnp.broadcast_to(
            attention_bias,
            (attention_bias.shape[0], attention_bias.shape[1], Sq, Sk),
        )
        bias_p = pad_to_multiple(pad_to_multiple(bias_p, pad_q, 2), pad_kv, 3)

    if attention_mask is not None:
        qlen = attention_mask.astype(jnp.int32).sum(-1)
        lens = jnp.stack([qlen, qlen], axis=-1)
    else:
        lens = jnp.broadcast_to(jnp.array([[Sq, Sk]], jnp.int32), (B, 2)).copy()
    if dropout_p > 0.0:
        if dropout_seed is not None:
            seed = dropout_seed
        elif dropout_rng is not None:
            seed = jax.random.randint(
                dropout_rng, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32
            )
        else:
            raise ValueError(
                "dropout_p > 0 requires dropout_seed or dropout_rng: a pure "
                "function cannot draw the reference's per-call random seed "
                "(src/utils.py:86), and a silent fixed default would reuse "
                "one dropout mask across every layer and step."
            )
    else:
        seed = dropout_seed if dropout_seed is not None else 0
    scalars = jnp.array([[0, 0, 0, 0]], jnp.int32).at[0, 2].set(seed)

    cfg = AttnConfig(
        causal=causal,
        softmax_scale=scale,
        window=tuple(window_size),
        softcap=float(softcap),
        dropout_p=float(dropout_p),
        blocks=blocks,
        seqlen_q_real=Sq,
        seqlen_k_real=Sk,
    )
    o, lse = _attn_core(cfg, qT, kT, vT, bias_p, lens, scalars)
    out = jnp.transpose(o[:, :, :Sq, :D], (0, 2, 1, 3)).astype(out_dtype)
    if return_lse:
        return out, lse[:, :, :Sq, 0]
    return out


def flash_attn_with_kv_cache(
    q: jax.Array,          # [B, S_step, Hq, D] — new queries
    k_cache: jax.Array,    # [B, S_max, Hkv, D] — cache incl. the new tokens
    v_cache: jax.Array,
    kv_len: jax.Array,     # scalar int32: total valid tokens (cache + step)
    softmax_scale: Optional[float] = None,
    window_left: int = -1,  # sliding-window prefix (-1 = full causal)
    softcap: float = 0.0,   # Gemma2-style tanh score capping (0 = off)
) -> jax.Array:
    """Decode/prefill attention over a KV cache prefix (inference path).

    Query rows sit at global positions [kv_len - S_step, kv_len) and attend
    causally to cache positions < kv_len, exercising the forward kernel's
    global position offsets. Pads per call unless S_max is a multiple of the
    KV block and head_dim a power of two (pre-padded caches).
    """
    B, S_step, Hq, D = q.shape
    S_max = k_cache.shape[1]
    scale = float(softmax_scale) if softmax_scale is not None else default_softmax_scale(D)
    Dp = head_dim_padded(D)
    blocks = choose_block_sizes(S_step, S_max, Dp,
                                dtype_bits=q.dtype.itemsize * 8)
    qT = pad_to_multiple(pad_to_multiple(_to_bhsd(q), blocks.block_q, 2), Dp, 3)
    kT = pad_to_multiple(pad_to_multiple(_to_bhsd(k_cache), blocks.block_kv, 2), Dp, 3)
    vT = pad_to_multiple(pad_to_multiple(_to_bhsd(v_cache), blocks.block_kv, 2), Dp, 3)

    kv_len = kv_len.astype(jnp.int32).reshape(())
    q_off = kv_len - S_step
    lens = jnp.broadcast_to(jnp.stack([kv_len, kv_len]).reshape(1, 2), (B, 2))
    scalars = jnp.stack(
        [q_off, jnp.int32(0), jnp.int32(0), jnp.int32(0)]
    ).reshape(1, 4)

    o, _ = flash_attn_forward(
        qT, kT, vT, lens, scalars, None,
        causal=True, softmax_scale=scale,
        window=(window_left, 0) if window_left >= 0 else (-1, -1),
        softcap=softcap,
        seqlen_q_real=S_step, seqlen_k_real=S_max,
        block_q=blocks.block_q, block_kv=blocks.block_kv,
    )
    return jnp.transpose(o[:, :, :S_step, :D], (0, 2, 1, 3))
