"""Single-step decode attention over (optionally quantized) KV caches.

The serving hot path: one new query token per sequence attends to that
sequence's KV-cache prefix. Decode is bandwidth-bound (the cost is streaming
the KV cache), so the kernel

* gives each program one (batch, KV head, KV split): the KV head's whole GQA
  query group rides as the rows of one tile (padded to 16, the smallest
  `tl.dot` operand), so every K/V byte is read once per step;
* splits long caches across programs so a small batch still fills the card,
  and merges the splits' partial softmax states by their LSE in XLA;
* reads only live blocks: each split loops up to the sequence's length (and
  from its sliding-window start), and the paged variant follows the block
  table one page at a time;
* dequantizes int8/fp8 K/V tiles in registers: column scales commute with
  the contraction (qk[i,j]*s_k[j], (p o s_v) @ v), so dequant is a cast and
  two row-vector multiplies. Scales live as [.., 1, S] rows so a block's
  scales are one contiguous vector.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from fa2_jax.utils import (
    LOG2E,
    cdiv,
    default_softmax_scale,
    dot_precision,
    kernel_call,
    next_power_of_2,
    pad_to_multiple,
)

MASK_LOG2 = -1e30
GROUP_ROWS = 16      # minimum rows of a `tl.dot` operand
TARGET_PROGRAMS = 264  # two programs per SM of a 132-SM H100


def _check_cache(cache_dtype, k_scale):
    quantized = k_scale is not None
    assert quantized or jnp.dtype(cache_dtype) in (
        jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16),
        jnp.dtype(jnp.float32)), (
        f"a {jnp.dtype(cache_dtype).name} KV cache needs its k_scale/v_scale")
    return quantized


def _num_splits(programs: int, num_blocks: int) -> int:
    """KV splits per (batch, KV head): enough programs to fill the card."""
    want = max(1, cdiv(TARGET_PROGRAMS, max(programs, 1)))
    return max(1, min(num_blocks, want))


def _decode_kernel(lens_ref, q_ref, k_ref, v_ref, *refs, scale, block_kv,
                   blocks_per_split, quantized, paged, window_left, softcap):
    refs = list(refs)
    ks_ref = vs_ref = tables_ref = None
    if quantized:
        ks_ref, vs_ref = refs.pop(0), refs.pop(0)
    if paged:
        tables_ref = refs.pop(0)
    o_ref, lse_ref = refs
    split = pl.program_id(2)
    kv_len = lens_ref[0]
    q = q_ref[...]
    first = 0
    if window_left >= 0:
        # The (single) query row sits at position kv_len - 1.
        first = jnp.maximum(kv_len - 1 - window_left, 0) // block_kv
    lo = jnp.maximum(split * blocks_per_split, first)
    hi = jnp.minimum((split + 1) * blocks_per_split, cdiv(kv_len, block_kv))

    def body(j, carry):
        acc, m_prev, l_prev = carry
        if paged:
            page = tables_ref[j]
            k = k_ref[page, :, :]
            v = v_ref[page, :, :]
        else:
            start = pl.multiple_of(j * block_kv, block_kv)
            k = k_ref[pl.ds(start, block_kv), :]
            v = v_ref[pl.ds(start, block_kv), :]
        if quantized:
            k = k.astype(q.dtype)
            v = v.astype(q.dtype)
        s = pl.dot(q, k, trans_b=True, precision=dot_precision(q, k))
        if quantized:
            ks = ks_ref[page, :] if paged else ks_ref[pl.ds(start, block_kv)]
            s = s * ks[None, :]
        if softcap > 0.0:
            # Cap in NATURAL units (the oracle/FA2 convention:
            # cap * tanh(s * scale / cap)), then convert to log2 domain.
            s2 = softcap * jnp.tanh(s * (scale / softcap)) * LOG2E
        else:
            s2 = s * (scale * LOG2E)
        cols = j * block_kv + jnp.arange(block_kv, dtype=jnp.int32)
        keep = cols < kv_len
        if window_left >= 0:
            keep = jnp.logical_and(keep, cols >= kv_len - 1 - window_left)
        s2 = jnp.where(keep[None, :], s2, MASK_LOG2)
        m_new = jnp.maximum(m_prev, jnp.max(s2, axis=1))
        alpha = jnp.exp2(m_prev - m_new)
        p = jnp.exp2(s2 - m_new[:, None])
        l_new = l_prev * alpha + jnp.sum(p, axis=1)
        if quantized:
            # Row scales of V fold into P: (p o s_v) @ v_q.
            vs = vs_ref[page, :] if paged else vs_ref[pl.ds(start, block_kv)]
            p = p * vs[None, :]
        acc = acc * alpha[:, None] + pl.dot(
            p.astype(v.dtype), v, precision=dot_precision(v))
        return acc, m_new, l_new

    rows = q_ref.shape[0]
    acc, m, l = lax.fori_loop(
        lo, hi, body,
        (jnp.zeros(q_ref.shape, jnp.float32),
         jnp.full((rows,), MASK_LOG2, jnp.float32),
         jnp.zeros((rows,), jnp.float32)))
    live = l > 0.0
    o_ref[...] = jnp.where(live[:, None], acc / jnp.where(live, l, 1.0)[:, None],
                           0.0)
    lse_ref[...] = jnp.where(live, m + jnp.log2(jnp.where(live, l, 1.0)),
                             -jnp.inf)


def _merge_splits(o, lse):
    """Combine per-split normalized outputs by their base-2 LSE."""
    if o.shape[2] == 1:
        return o[:, :, 0]
    m = jnp.max(lse, axis=2, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp2(lse - m)
    den = jnp.sum(w, axis=2)
    num = jnp.sum(w[..., None] * o, axis=2)
    return jnp.where(den[..., None] > 0.0, num / jnp.where(
        den > 0.0, den, 1.0)[..., None], 0.0)


def _launch(q, k, v, kv_lens, scales, tables, *, kv_spec, scale_spec,
            num_blocks, block_kv, Hkv, window_left, softcap, softmax_scale):
    B, Hq, D = q.shape
    group = Hq // Hkv
    rows = max(GROUP_ROWS, next_power_of_2(group))
    # [B, Hq, D] -> [B, Hkv, rows, D] (group-major rows per KV head).
    qg = pad_to_multiple(q.reshape(B, Hkv, group, D), rows, 2)
    splits = _num_splits(B * Hkv, num_blocks)
    per_split = cdiv(num_blocks, splits)
    splits = cdiv(num_blocks, per_split)
    in_specs = [
        pl.BlockSpec((None, 1), lambda b, h, s: (b, 0)),
        pl.BlockSpec((None, None, rows, D), lambda b, h, s: (b, h, 0, 0)),
        kv_spec, kv_spec,
    ]
    args = [kv_lens.astype(jnp.int32).reshape(B, 1), qg, k, v]
    quantized = scales is not None
    if quantized:
        in_specs += [scale_spec, scale_spec]
        args += list(scales)
    if tables is not None:
        in_specs.append(pl.BlockSpec((None, tables.shape[1]),
                                     lambda b, h, s: (b, 0)))
        args.append(tables.astype(jnp.int32))
    o, lse = kernel_call(
        functools.partial(
            _decode_kernel,
            scale=(softmax_scale if softmax_scale is not None
                   else default_softmax_scale(D)),
            block_kv=block_kv, blocks_per_split=per_split,
            quantized=quantized, paged=tables is not None,
            window_left=window_left, softcap=softcap),
        name="paged_decode" if tables is not None else "decode",
        num_warps=4, num_stages=2,
        grid=(B, Hkv, splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, rows, D),
                         lambda b, h, s: (b, h, s, 0, 0)),
            pl.BlockSpec((None, None, None, rows), lambda b, h, s: (b, h, s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, Hkv, splits, rows, D), jnp.float32),
            jax.ShapeDtypeStruct((B, Hkv, splits, rows), jnp.float32),
        ],
    )(*args)
    o = _merge_splits(o, lse)
    return o[:, :, :group].reshape(B, Hq, D).astype(q.dtype)


def decode_attention(
    q: jax.Array,                 # [B, Hq, D] — one new token per sequence
    k_cache: jax.Array,           # [B, Hkv, S_max, D] (qdtype or compute dtype)
    v_cache: jax.Array,
    kv_lens: jax.Array,           # [B] int32 — valid tokens per sequence
    k_scale: Optional[jax.Array] = None,   # [B, Hkv, 1, S_max] f32 if quantized
    v_scale: Optional[jax.Array] = None,
    *,
    softmax_scale: Optional[float] = None,
    block_kv: int = 128,
    window_left: int = -1,
    softcap: float = 0.0,
) -> jax.Array:
    """Returns attention output [B, Hq, D]. Cache layout is BHSD with D a
    power of two (allocate caches padded — see `runtime/kv_cache.py`);
    scales [B, Hkv, 1, S_max]. int8 and fp8 caches need their scales.
    `window_left >= 0` = sliding-window decode: only the last window_left+1
    positions are attended (blocks before the window are never read)."""
    B, Hq, D = q.shape
    Hkv, S_max = k_cache.shape[1], k_cache.shape[2]
    assert Hq % Hkv == 0
    quantized = _check_cache(k_cache.dtype, k_scale)
    # Shrink the block until it divides the cache extent.
    block_kv = min(block_kv, next_power_of_2(S_max))
    while S_max % block_kv:
        block_kv //= 2
    assert block_kv >= GROUP_ROWS, "allocate caches padded: S_max % 16 == 0"
    if quantized:
        assert k_scale.shape == (B, Hkv, 1, S_max), k_scale.shape
    return _launch(
        q, k_cache, v_cache, kv_lens,
        (k_scale, v_scale) if quantized else None, None,
        kv_spec=pl.BlockSpec((None, None, S_max, D),
                             lambda b, h, s: (b, h, 0, 0)),
        scale_spec=pl.BlockSpec((None, None, None, S_max),
                                lambda b, h, s: (b, h, 0, 0)),
        num_blocks=S_max // block_kv, block_kv=block_kv, Hkv=Hkv,
        window_left=window_left, softcap=softcap,
        softmax_scale=softmax_scale)


def paged_decode_attention(
    q: jax.Array,                 # [B, Hq, D] — one new token per sequence
    k_pool: jax.Array,            # [n_pages, Hkv, page_size, D]
    v_pool: jax.Array,
    block_tables: jax.Array,      # [B, max_pages] int32 physical page ids
    kv_lens: jax.Array,           # [B] int32 — valid tokens per sequence
    k_scale: Optional[jax.Array] = None,   # [n_pages, Hkv, 1, page_size]
    v_scale: Optional[jax.Array] = None,
    *,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
) -> jax.Array:
    """Decode attention over a PAGED KV cache (vLLM-style block tables).

    Sequence position p of batch b lives at physical page
    `block_tables[b, p // page_size]`, row `p % page_size`. Each program
    reads its own table row and loads one live page per loop step; no
    gather materializes, and pages past each sequence's length are never
    read.
    """
    B, Hq, D = q.shape
    n_pages, Hkv, page_size = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    assert Hq % Hkv == 0
    assert page_size >= GROUP_ROWS and page_size & (page_size - 1) == 0, (
        "page_size must be a power of two, at least 16")
    quantized = _check_cache(k_pool.dtype, k_scale)
    if quantized:
        assert k_scale.shape == (n_pages, Hkv, 1, page_size), k_scale.shape
    return _launch(
        q, k_pool, v_pool, kv_lens,
        (k_scale, v_scale) if quantized else None, block_tables,
        kv_spec=pl.BlockSpec((n_pages, None, page_size, D),
                             lambda b, h, s: (0, h, 0, 0)),
        scale_spec=pl.BlockSpec((n_pages, None, None, page_size),
                                lambda b, h, s: (0, h, 0, 0)),
        num_blocks=block_tables.shape[1], block_kv=page_size, Hkv=Hkv,
        window_left=window_left, softcap=softcap,
        softmax_scale=softmax_scale)
