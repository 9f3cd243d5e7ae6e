"""FlashAttention-2 forward as a Pallas kernel on the Triton route.

The reference forward (`/root/reference/src/forward/kernel.py`) written
again for JAX: one program per (q block, batch, head), an inner loop over
KV blocks carrying the online-softmax state (m, l, acc) in registers, and
the base-2 logsumexp stored in float32.

* Loop bounds come from the traced per-batch lengths `lens` [B, 2] and the
  global offsets in `scalars` [1, 4] = (q_offset, kv_offset, dropout_seed,
  _): causal (bottom-right aligned on the actual lengths), sliding windows
  and padded tails only ever visit the KV blocks they need. Blocks that are
  entirely inside the valid region run a body with no mask at all; only the
  boundary blocks on either side pay for iota/compare/select.
* Scores are scaled by softmax_scale*log2(e) so the softmax is exp2 (the
  reference's `qk_scale`, `src/forward/kernel.py:119`); softcap and bias
  work in natural units and convert afterwards.
* GQA maps query head h to KV head h // group in the K/V index maps
  (reference `src/forward/kernel.py:100-101`).
* Dropout keeps the counter hash over global (b, h, row, col) offsets
  (`utils/rng.py`) — plain uint32 ops, so the oracle regenerates the
  identical mask — with the 1/(1-p) compensation in the final rescale.
* The global offsets let ring/sequence-parallel attention and chunked
  prefill reuse the kernel unchanged per KV shard or cache prefix.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from fa2_jax.ops.tuning import choose_block_sizes
from fa2_jax.utils import LOG2E, cdiv, dot_precision, kernel_call
from fa2_jax.utils.rng import counter_hash_uint32, dropout_threshold

# Finite mask constant in the log2 domain; exp2(x - m) underflows to 0 for any
# plausible m. Finite so (masked - masked) never yields NaN.
MASK_LOG2 = -1e30


def scores_log2(q, k, bias_tile, *, scale, softcap, prescaled):
    """Base-2 score tile s*scale*log2(e) (after softcap and bias) in f32.

    Returns (s2, capped): `capped` is the post-softcap natural-unit score
    the backward needs for the tanh derivative (None without softcap)."""
    s = pl.dot(q, k, trans_b=True, precision=dot_precision(q, k))
    if softcap > 0.0 or bias_tile is not None:
        s = s * (1.0 / LOG2E) if prescaled else s * scale
        capped = None
        if softcap > 0.0:
            s = jnp.tanh(s / softcap) * softcap
            capped = s
        if bias_tile is not None:
            s = s + bias_tile.astype(jnp.float32)
        return s * LOG2E, capped
    return (s if prescaled else s * (scale * LOG2E)), None


def keep_mask(row_g, col_g, *, kv_len, shift, causal, window):
    """Validity of (row, col) pairs: column inside the actual KV length and
    inside the bottom-right aligned causal/window band
    (oracle `construct_local_mask`)."""
    keep = col_g < kv_len
    if causal or window[1] >= 0:
        right = 0 if causal else window[1]
        keep = jnp.logical_and(keep, col_g <= row_g + shift + right)
    if window[0] >= 0:
        keep = jnp.logical_and(keep, col_g >= row_g + shift - window[0])
    return keep


def dropout_keep(seed, b, h, row_g, col_g, *, num_q_heads, seqlen_q_real,
                 seqlen_k_real, dropout_p):
    """Keep-bits of one tile of the dense dropout stream (`utils/rng.py`)."""
    flat = (
        (b.astype(jnp.uint32) * jnp.uint32(num_q_heads)
         + h.astype(jnp.uint32)) * jnp.uint32(seqlen_q_real)
        + row_g.astype(jnp.uint32)
    ) * jnp.uint32(seqlen_k_real) + col_g.astype(jnp.uint32)
    bits = counter_hash_uint32(seed.astype(jnp.uint32), flat)
    return bits >= jnp.uint32(dropout_threshold(dropout_p))


def online_softmax_step(carry, s2, v, drop_keep=None):
    """One KV block of the base-2 online softmax: (acc, m, l) -> updated.

    The denominator l sums the UNDROPPED p (dropout only zeroes the PV
    numerator; the oracle applies the mask after normalization)."""
    acc, m_prev, l_prev = carry
    m_new = jnp.maximum(m_prev, jnp.max(s2, axis=1))
    alpha = jnp.exp2(m_prev - m_new)
    p = jnp.exp2(s2 - m_new[:, None])
    l_new = l_prev * alpha + jnp.sum(p, axis=1)
    if drop_keep is not None:
        p = jnp.where(drop_keep, p, 0.0)
    acc = acc * alpha[:, None] + pl.dot(
        p.astype(v.dtype), v, precision=dot_precision(v))
    return acc, m_new, l_new


def softmax_init(rows: int, width: int):
    return (jnp.zeros((rows, width), jnp.float32),
            jnp.full((rows,), MASK_LOG2, jnp.float32),
            jnp.zeros((rows,), jnp.float32))


def softmax_finish(carry, valid, dropout_p):
    """Normalize (acc, m, l) into (o f32, lse base-2).

    Rows with no valid column so far carry p == 1 poison through fully
    masked blocks; the first valid block rescales it away by
    exp2(MASK - m) == 0, and rows that never see a valid column are
    overwritten here (`valid` False) with the oracle's zero-fill / -inf."""
    acc, m, l = carry
    l_inv = jnp.where(l > 0.0, 1.0 / l, 0.0)
    if dropout_p > 0.0:
        l_inv = l_inv / (1.0 - dropout_p)
    o = jnp.where(valid[:, None], acc * l_inv[:, None], 0.0)
    return o, jnp.where(valid, m + jnp.log2(l), -jnp.inf)


def kv_block_range(row_lo, row_hi, *, q_len, kv_len, kv_off, block_kv,
                   num_kv_blocks, causal, window):
    """KV blocks rows [row_lo, row_hi] (global) need, split by masking.

    Returns (lo, full_lo, full_hi, hi): blocks [lo, hi) are visited;
    [full_lo, full_hi) are entirely valid for every row of the block (no
    mask needed); [lo, full_lo) and [full_hi, hi) carry the band edges and
    the padded tail."""
    shift = kv_len - q_len
    col_end = kv_len                      # exclusive, global
    col_full_end = kv_len
    if causal or window[1] >= 0:
        right = 0 if causal else window[1]
        col_end = jnp.minimum(col_end, row_hi + shift + right + 1)
        col_full_end = jnp.minimum(col_full_end, row_lo + shift + right + 1)
    hi = jnp.clip(cdiv(col_end - kv_off, block_kv), 0, num_kv_blocks)
    full_hi = jnp.clip((col_full_end - kv_off) // block_kv, 0, num_kv_blocks)
    lo = jnp.int32(0)
    full_lo = jnp.int32(0)
    if window[0] >= 0:
        lo = jnp.clip((row_lo + shift - window[0] - kv_off) // block_kv, 0,
                      num_kv_blocks)
        full_lo = jnp.clip(
            cdiv(row_hi + shift - window[0] - kv_off, block_kv), 0,
            num_kv_blocks)
    # Rows past the actual query length have nothing to attend to.
    hi = jnp.where(row_lo < q_len, hi, 0)
    lo = jnp.minimum(lo, hi)
    full_lo = jnp.clip(full_lo, lo, hi)
    full_hi = jnp.clip(full_hi, full_lo, hi)
    return lo, full_lo, full_hi, hi


def _fwd_kernel(lens_ref, scal_ref, q_ref, k_ref, v_ref, *refs, scale,
                causal, window, softcap, dropout_p, block_q, block_kv,
                num_kv_blocks, seqlen_q_real, seqlen_k_real, num_q_heads,
                prescaled, has_bias):
    if has_bias:
        bias_ref, o_ref, lse_ref = refs
    else:
        bias_ref = None
        o_ref, lse_ref = refs
    iq, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    q_len, kv_len = lens_ref[0], lens_ref[1]
    q_off, kv_off, seed = scal_ref[0], scal_ref[1], scal_ref[2]
    shift = kv_len - q_len
    row_lo = q_off + iq * block_q
    rows = row_lo + jnp.arange(block_q, dtype=jnp.int32)
    q = q_ref[...]

    def body(j, carry, masked):
        start = pl.multiple_of(j * block_kv, block_kv)
        k = k_ref[pl.ds(start, block_kv), :]
        bias_tile = (None if bias_ref is None
                     else bias_ref[:, pl.ds(start, block_kv)])
        s2, _ = scores_log2(q, k, bias_tile, scale=scale, softcap=softcap,
                            prescaled=prescaled)
        cols = kv_off + start + jnp.arange(block_kv, dtype=jnp.int32)
        if masked:
            keep = keep_mask(rows[:, None], cols[None, :], kv_len=kv_len,
                             shift=shift, causal=causal, window=window)
            s2 = jnp.where(keep, s2, MASK_LOG2)
        drop_keep = None
        if dropout_p > 0.0:
            drop_keep = dropout_keep(
                seed, b, h, rows[:, None], cols[None, :],
                num_q_heads=num_q_heads, seqlen_q_real=seqlen_q_real,
                seqlen_k_real=seqlen_k_real, dropout_p=dropout_p)
        v = v_ref[pl.ds(start, block_kv), :]
        return online_softmax_step(carry, s2, v, drop_keep)

    lo, full_lo, full_hi, hi = kv_block_range(
        row_lo, row_lo + block_q - 1, q_len=q_len, kv_len=kv_len,
        kv_off=kv_off, block_kv=block_kv, num_kv_blocks=num_kv_blocks,
        causal=causal, window=window)
    carry = softmax_init(block_q, q_ref.shape[-1])
    masked_body = functools.partial(body, masked=True)
    carry = lax.fori_loop(lo, full_lo, masked_body, carry)
    carry = lax.fori_loop(full_lo, full_hi,
                          functools.partial(body, masked=False), carry)
    carry = lax.fori_loop(full_hi, hi, masked_body, carry)

    valid = rows < q_len
    if causal or window[1] >= 0:
        right = 0 if causal else window[1]
        valid = jnp.logical_and(valid, rows + shift + right >= 0)
    if window[0] >= 0:
        valid = jnp.logical_and(valid, rows + shift - window[0] < kv_len)
    o, lse = softmax_finish(carry, valid, dropout_p)
    o_ref[...] = o.astype(o_ref.dtype)
    lse_ref[...] = lse


def flash_attn_forward(
    q: jax.Array,               # [B, Hq, Sq, D]  BHSD, padded to blocks
    k: jax.Array,               # [B, Hkv, Sk, D]
    v: jax.Array,               # [B, Hkv, Sk, D]
    lens: jax.Array,            # [B, 2] int32 (q_len, kv_len) actual lengths
    scalars: jax.Array,         # [1, 4] int32 (q_off, kv_off, dropout_seed, _)
    bias: Optional[jax.Array],  # [Bb, Hb, Sq, Sk] or None (Bb/Hb may be 1)
    *,
    causal: bool,
    softmax_scale: float,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    seqlen_q_real: Optional[int] = None,
    seqlen_k_real: Optional[int] = None,
    q_prescaled: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    num_warps: Optional[int] = None,
    num_stages: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Launch the forward kernel on BHSD tensors already padded to blocks.

    `q_prescaled=True` means the caller already multiplied q by
    softmax_scale*log2(e) (loop callers like ring attention hoist this out
    of their per-chunk loop). Per-batch lengths shorter than the padded
    extents need no flag: the kernel always reads its bounds from `lens`.

    Returns (o [B, Hq, Sq, D], lse [B, Hq, Sq, 1] base-2 units, fp32).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    blocks = choose_block_sizes(Sq, Sk, D, dtype_bits=q.dtype.itemsize * 8)
    block_q = block_q or blocks.block_q
    block_kv = block_kv or blocks.block_kv
    assert Sq % block_q == 0 and Sk % block_kv == 0, (Sq, Sk, block_q, block_kv)
    assert Hq % Hkv == 0
    group = Hq // Hkv
    kernel = functools.partial(
        _fwd_kernel, scale=softmax_scale, causal=causal, window=tuple(window),
        softcap=softcap, dropout_p=dropout_p, block_q=block_q,
        block_kv=block_kv, num_kv_blocks=Sk // block_kv,
        seqlen_q_real=seqlen_q_real or Sq, seqlen_k_real=seqlen_k_real or Sk,
        num_q_heads=Hq, prescaled=q_prescaled, has_bias=bias is not None)
    in_specs = [
        pl.BlockSpec((None, 2), lambda i, b, h: (b, 0)),
        pl.BlockSpec((None, 4), lambda i, b, h: (0, 0)),
        pl.BlockSpec((None, None, block_q, D), lambda i, b, h: (b, h, i, 0)),
        pl.BlockSpec((None, None, Sk, D), lambda i, b, h: (b, h // group, 0, 0)),
        pl.BlockSpec((None, None, Sk, D), lambda i, b, h: (b, h // group, 0, 0)),
    ]
    args = [lens.astype(jnp.int32), scalars.astype(jnp.int32), q, k, v]
    if bias is not None:
        Bb, Hb = bias.shape[:2]
        in_specs.append(pl.BlockSpec(
            (None, None, block_q, Sk),
            lambda i, b, h: (b if Bb > 1 else 0, h if Hb > 1 else 0, i, 0)))
        args.append(bias)
    o, lse = kernel_call(
        kernel,
        name="flash_fwd",
        num_warps=num_warps or blocks.num_warps,
        num_stages=num_stages or blocks.num_stages,
        grid=(Sq // block_q, B, Hq),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, block_q, D), lambda i, b, h: (b, h, i, 0)),
            pl.BlockSpec((None, None, block_q), lambda i, b, h: (b, h, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, Hq, Sq, D), q.dtype),
            jax.ShapeDtypeStruct((B, Hq, Sq), jnp.float32),
        ],
    )(*args)
    return o, lse[..., None]
