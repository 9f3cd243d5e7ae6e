"""Packed (zero-waste) variable-length attention — index-list kernels.

The reference physically packs right-padded batches into one [1, sum(len)]
sequence with cumulative-seqlen offsets so padded tokens cost nothing
(`/root/reference/src/forward/caller.py:44-63`). Here:

* sequences are packed back-to-back, each padded to the block alignment
  (`pack_padded_batch`), with STATIC (host-known) cumulative offsets;
* the host lists, for each packed q block, exactly the KV blocks that carry
  real work for it, and for each KV block the q blocks that see it —
  causally-skipped and out-of-segment pairs are never visited; each program
  loads its own index row, so cost scales with live blocks;
* the forward and dq kernels run one program per (q block, head) over its
  list; the dk/dv kernel one per (KV block, KV head) over its list and the
  GQA group. Block-sparse attention (splash-style) falls out of the same
  lists.

Segment semantics per packed sequence match the dense kernels: causal
masking bottom-right-aligned on the true (unpadded) lengths, base-2 LSE,
padded tail rows zero-filled with lse = -inf.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from fa2_jax.ops.flash_bwd import tile_grads
from fa2_jax.ops.flash_fwd import (
    MASK_LOG2,
    online_softmax_step,
    scores_log2,
    softmax_finish,
    softmax_init,
)
from fa2_jax.utils import (
    LOG2E,
    default_softmax_scale,
    dot_precision,
    head_dim_padded,
    kernel_call,
    round_up_to_multiple,
)
from fa2_jax.utils.rng import counter_hash_uint32, dropout_threshold


# ------------------------------ packing -----------------------------------

def pack_padded_batch(xs: Sequence[jax.Array], lens: Sequence[int],
                      align: int = 128):
    """Pack right-padded [B, S, ...] arrays into [1, T, ...] with each
    sequence start aligned to `align` (so kernel blocks never straddle a
    segment boundary). `lens` must be CONCRETE ints — packing layout is a
    host-side decision, exactly like the reference's `attention_pack`.

    Returns (packed list, seg_starts [B] np.int32, T)."""
    lens = [int(l) for l in lens]
    starts = np.cumsum([0] + [round_up_to_multiple(max(l, 1), align)
                              for l in lens[:-1]]).astype(np.int32)
    T = int(starts[-1]) + round_up_to_multiple(max(lens[-1], 1), align)
    packed = []
    for x in xs:
        B, S = x.shape[:2]
        out = jnp.zeros((1, T) + x.shape[2:], x.dtype)
        for b in range(B):
            out = jax.lax.dynamic_update_slice_in_dim(
                out, x[b:b + 1, :lens[b]], int(starts[b]), axis=1)
        packed.append(out)
    return packed, starts, T


def unpack_padded_batch(xp: jax.Array, seg_starts: np.ndarray,
                        lens: Sequence[int], seqlen: int) -> jax.Array:
    """Inverse of `pack_padded_batch` for one array: [1, T, ...] -> [B, S, ...]
    (padded tail positions zero-filled)."""
    B = len(lens)
    rows = []
    for b in range(B):
        row = jax.lax.dynamic_slice_in_dim(
            xp, int(seg_starts[b]), min(int(lens[b]), seqlen), axis=1)
        pad = seqlen - row.shape[1]
        if pad:
            row = jnp.pad(row, ((0, 0), (0, pad)) + ((0, 0),) * (xp.ndim - 2))
        rows.append(row)
    return jnp.concatenate(rows, axis=0)


# --------------------------- schedule builder -----------------------------

def _seg_extents(seg_starts, T: int):
    starts = [int(s) for s in seg_starts]
    return [b - a for a, b in zip(starts, starts[1:] + [int(T)])]


def _build_schedule(seg_starts, seg_exts, seg_qlens, seg_kvlens,
                    block_q, block_kv, causal, kv_major=False,
                    keep_block=None):
    """Host-side per-program index lists (see module docstring).

    Returns (meta [n_blocks, 5] int32, lists [n_blocks, max_live] int32).
    Row-major (kv_major=False): one row per packed q block, listing the
    packed KV blocks its rows see; kv_major=True: one row per packed KV
    block, listing the packed q blocks that see it. meta row =
    (offset of the block inside its segment, segment q_len, segment
    kv_len, segment start, number of live entries). A block with no live
    entry (padded tail, negative-shift causal, block-sparse filtered) is
    zero-filled by its program.

    `keep_block(seg, jq, jk) -> bool` optionally filters (q block, kv block)
    pairs at BLOCK granularity (segment-local indices) — block-sparse
    attention: the softmax normalizes over the surviving blocks only."""
    meta, lists = [], []
    for s in range(len(seg_qlens)):
        q0 = int(seg_starts[s])
        ext = int(seg_exts[s])
        qlen, kvlen = int(seg_qlens[s]), int(seg_kvlens[s])
        shift = kvlen - qlen

        def live(jq, jk):
            q_lo, kv_lo = jq * block_q, jk * block_kv
            return (q_lo < qlen and kv_lo < kvlen
                    and not (causal and kv_lo > q_lo + block_q - 1 + shift)
                    and (keep_block is None or keep_block(s, jq, jk)))

        nq, nkv = ext // block_q, ext // block_kv
        if kv_major:
            for jk in range(nkv):
                row = [(q0 // block_q) + jq for jq in range(nq) if live(jq, jk)]
                meta.append([jk * block_kv, qlen, kvlen, q0, len(row)])
                lists.append(row)
        else:
            for jq in range(nq):
                row = [(q0 // block_kv) + jk for jk in range(nkv)
                       if live(jq, jk)]
                meta.append([jq * block_q, qlen, kvlen, q0, len(row)])
                lists.append(row)
    width = max(1, max(len(r) for r in lists))
    table = np.zeros((len(lists), width), np.int32)
    for i, r in enumerate(lists):
        table[i, :len(r)] = r
    return np.asarray(meta, np.int32), table


def _packed_dropout_keep(seed, h, row_gp, col_gp, dropout_p):
    """Keep-bits for one tile of the packed dropout stream.

    The stream is a CHAINED counter hash over the GLOBAL PACKED coordinates:
    hash(hash(hash(seed, h), row_packed), col_packed). Chaining (a PRF
    composition) rather than flattening `(h*T + row)*T + col` keeps streams
    distinct for ANY packed total — the flat uint32 form collides once
    Hq*T^2 wraps 2^32 (at T = 65536 every head would share one mask). The
    oracle regenerates the identical mask from the same composition
    (tests/test_varlen_packed.py)."""
    s_h = counter_hash_uint32(seed.astype(jnp.uint32), h.astype(jnp.uint32))
    bits = counter_hash_uint32(
        counter_hash_uint32(s_h, row_gp.astype(jnp.uint32)),
        col_gp.astype(jnp.uint32))
    return bits >= jnp.uint32(dropout_threshold(dropout_p))


def _segment_keep(rows, cols, qlen, kvlen, causal):
    keep = cols[None, :] < kvlen
    if causal:
        keep = jnp.logical_and(keep, cols[None, :] <= rows[:, None]
                               + (kvlen - qlen))
    return keep


# ------------------------------ forward -----------------------------------

def _varlen_fwd_kernel(meta_ref, list_ref, seed_ref, q_ref, k_ref, v_ref,
                       o_ref, lse_ref, *, causal, scale, block_q, block_kv,
                       dropout_p):
    iq, h = pl.program_id(0), pl.program_id(1)
    q_lo, qlen, kvlen = meta_ref[0], meta_ref[1], meta_ref[2]
    seg0, n_live = meta_ref[3], meta_ref[4]
    seed = seed_ref[0]
    rows = q_lo + jnp.arange(block_q, dtype=jnp.int32)
    rows_p = iq * block_q + jnp.arange(block_q, dtype=jnp.int32)
    q = q_ref[...]

    def body(t, carry):
        start = pl.multiple_of(list_ref[t] * block_kv, block_kv)
        k = k_ref[pl.ds(start, block_kv), :]
        s2, _ = scores_log2(q, k, None, scale=scale, softcap=0.0,
                            prescaled=False)
        cols = start - seg0 + jnp.arange(block_kv, dtype=jnp.int32)
        s2 = jnp.where(_segment_keep(rows, cols, qlen, kvlen, causal), s2,
                       MASK_LOG2)
        drop_keep = None
        if dropout_p > 0.0:
            cols_p = start + jnp.arange(block_kv, dtype=jnp.int32)
            drop_keep = _packed_dropout_keep(seed, h, rows_p[:, None],
                                             cols_p[None, :], dropout_p)
        return online_softmax_step(carry, s2, v_ref[pl.ds(start, block_kv), :],
                                   drop_keep)

    carry = lax.fori_loop(0, n_live, body,
                          softmax_init(block_q, q_ref.shape[-1]))
    valid = rows < qlen
    if causal:
        valid = jnp.logical_and(valid, rows + (kvlen - qlen) >= 0)
    o, lse = softmax_finish(carry, valid, dropout_p)
    o_ref[...] = o.astype(o_ref.dtype)
    lse_ref[...] = lse


def _sched_specs(meta, table):
    return (
        [pl.BlockSpec((None, meta.shape[1]), lambda i, h: (i, 0)),
         pl.BlockSpec((None, table.shape[1]), lambda i, h: (i, 0)),
         pl.BlockSpec((1,), lambda i, h: (0,))],
        [jnp.asarray(meta), jnp.asarray(table)])


def flash_attn_varlen_forward(
    q, k, v,                    # [1, H, T, D] packed BHSD, D padded
    seg_starts: np.ndarray,     # [B] static packed offsets (align-multiples)
    seg_qlens: Sequence[int], seg_kvlens: Sequence[int],
    *,
    causal: bool, softmax_scale: float,
    block_q: int = 128, block_kv: int = 128,
    dropout_p: float = 0.0, seed=0, keep_block=None,
):
    _, Hq, T, D = q.shape
    group = Hq // k.shape[1]
    assert T % block_q == 0 and T % block_kv == 0
    assert all(int(s) % max(block_q, block_kv) == 0 for s in seg_starts)
    meta, table = _build_schedule(
        seg_starts, _seg_extents(seg_starts, T), seg_qlens, seg_kvlens,
        block_q, block_kv, causal, keep_block=keep_block)
    specs, sched = _sched_specs(meta, table)
    full = pl.BlockSpec((None, None, T, D), lambda i, h: (0, h // group, 0, 0))
    blk = pl.BlockSpec((None, None, block_q, D), lambda i, h: (0, h, i, 0))
    o, lse = kernel_call(
        functools.partial(_varlen_fwd_kernel, causal=causal,
                          scale=softmax_scale, block_q=block_q,
                          block_kv=block_kv, dropout_p=dropout_p),
        name="flash_varlen_fwd",
        grid=(T // block_q, Hq),
        in_specs=specs + [blk, full, full],
        out_specs=[blk, pl.BlockSpec((None, None, block_q),
                                     lambda i, h: (0, h, i))],
        out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype),
                   jax.ShapeDtypeStruct((1, Hq, T), jnp.float32)],
    )(*sched, jnp.asarray(seed, jnp.int32).reshape(1), q, k, v)
    return o, lse[..., None]


# ------------------------------ backward ----------------------------------

def _varlen_dq_kernel(meta_ref, list_ref, seed_ref, q_ref, k_ref, v_ref,
                      do_ref, lse_ref, delta_ref, dq_ref, *, causal, scale,
                      block_q, block_kv, dropout_p):
    iq, h = pl.program_id(0), pl.program_id(1)
    q_lo, qlen, kvlen = meta_ref[0], meta_ref[1], meta_ref[2]
    seg0, n_live = meta_ref[3], meta_ref[4]
    seed = seed_ref[0]
    rows = q_lo + jnp.arange(block_q, dtype=jnp.int32)
    rows_p = iq * block_q + jnp.arange(block_q, dtype=jnp.int32)
    q, do = q_ref[...], do_ref[...]
    lse, delta = lse_ref[...], delta_ref[...]

    def body(t, acc):
        start = pl.multiple_of(list_ref[t] * block_kv, block_kv)
        k = k_ref[pl.ds(start, block_kv), :]
        cols = start - seg0 + jnp.arange(block_kv, dtype=jnp.int32)
        drop_keep = None
        if dropout_p > 0.0:
            cols_p = start + jnp.arange(block_kv, dtype=jnp.int32)
            drop_keep = _packed_dropout_keep(seed, h, rows_p[:, None],
                                             cols_p[None, :], dropout_p)
        _, ds, _ = tile_grads(
            q, k, v_ref[pl.ds(start, block_kv), :], do, lse, delta, None,
            _segment_keep(rows, cols, qlen, kvlen, causal), drop_keep,
            scale=scale, softcap=0.0, dropout_p=dropout_p)
        return acc + pl.dot(ds.astype(k.dtype), k, precision=dot_precision(k))

    acc = lax.fori_loop(0, n_live, body, jnp.zeros(q_ref.shape, jnp.float32))
    dq_ref[...] = (acc * scale).astype(dq_ref.dtype)


def _varlen_dkdv_kernel(meta_ref, list_ref, seed_ref, q_ref, k_ref, v_ref,
                        do_ref, lse_ref, delta_ref, dk_ref, dv_ref, *, causal,
                        scale, block_q, block_kv, dropout_p, group):
    ik, hkv = pl.program_id(0), pl.program_id(1)
    kv_lo, qlen, kvlen = meta_ref[0], meta_ref[1], meta_ref[2]
    seg0, n_live = meta_ref[3], meta_ref[4]
    seed = seed_ref[0]
    cols = kv_lo + jnp.arange(block_kv, dtype=jnp.int32)
    cols_p = ik * block_kv + jnp.arange(block_kv, dtype=jnp.int32)
    k, v = k_ref[...], v_ref[...]

    def body(t, carry, g):
        dk, dv = carry
        start = pl.multiple_of(list_ref[t] * block_q, block_q)
        q = q_ref[g, pl.ds(start, block_q), :]
        do = do_ref[g, pl.ds(start, block_q), :]
        rows = start - seg0 + jnp.arange(block_q, dtype=jnp.int32)
        drop_keep = None
        if dropout_p > 0.0:
            rows_p = start + jnp.arange(block_q, dtype=jnp.int32)
            drop_keep = _packed_dropout_keep(
                seed, hkv * group + g, rows_p[:, None], cols_p[None, :],
                dropout_p)
        p_drop, ds, _ = tile_grads(
            q, k, v, do, lse_ref[g, pl.ds(start, block_q)],
            delta_ref[g, pl.ds(start, block_q)], None,
            _segment_keep(rows, cols, qlen, kvlen, causal), drop_keep,
            scale=scale, softcap=0.0, dropout_p=dropout_p)
        dv = dv + pl.dot(p_drop.astype(do.dtype), do, trans_a=True,
                         precision=dot_precision(do))
        dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True,
                         precision=dot_precision(q))
        return dk, dv

    zeros = jnp.zeros(k_ref.shape, jnp.float32)
    dk, dv = lax.fori_loop(
        0, group,
        lambda g, c: lax.fori_loop(0, n_live, functools.partial(body, g=g), c),
        (zeros, zeros))
    dk_ref[...] = (dk * scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def flash_attn_varlen_backward(
    q, k, v, do, o, lse,        # packed BHSD / [1, H, T, 1]
    seg_starts, seg_qlens, seg_kvlens,
    *,
    causal: bool, softmax_scale: float,
    block_q: int = 128, block_kv: int = 128,
    dropout_p: float = 0.0, seed=0,
    dlse: Optional[jax.Array] = None, keep_block=None,
):
    _, Hq, T, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    lse = lse[..., 0]
    delta = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32), axis=-1)
    if dlse is not None:
        dlse = dlse.reshape(lse.shape)
        safe = jnp.logical_and(jnp.isfinite(lse), jnp.isfinite(dlse))
        delta = delta - jnp.where(safe, dlse, 0.0) * LOG2E
    lse = jnp.where(jnp.isfinite(lse), lse, jnp.inf)
    exts = _seg_extents(seg_starts, T)
    seed_arr = jnp.asarray(seed, jnp.int32).reshape(1)
    kw = dict(causal=causal, scale=softmax_scale, block_q=block_q,
              block_kv=block_kv, dropout_p=dropout_p)

    meta, table = _build_schedule(seg_starts, exts, seg_qlens, seg_kvlens,
                                  block_q, block_kv, causal,
                                  keep_block=keep_block)
    specs, sched = _sched_specs(meta, table)
    blk = pl.BlockSpec((None, None, block_q, D), lambda i, h: (0, h, i, 0))
    vec = pl.BlockSpec((None, None, block_q), lambda i, h: (0, h, i))
    full = pl.BlockSpec((None, None, T, D), lambda i, h: (0, h // group, 0, 0))
    dq = kernel_call(
        functools.partial(_varlen_dq_kernel, **kw),
        name="flash_varlen_dq",
        grid=(T // block_q, Hq),
        in_specs=specs + [blk, full, full, blk, vec, vec],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
    )(*sched, seed_arr, q, k, v, do, lse, delta)

    meta, table = _build_schedule(seg_starts, exts, seg_qlens, seg_kvlens,
                                  block_q, block_kv, causal, kv_major=True,
                                  keep_block=keep_block)
    specs, sched = _sched_specs(meta, table)
    grp = pl.BlockSpec((None, group, T, D), lambda j, g: (0, g, 0, 0))
    grp_vec = pl.BlockSpec((None, group, T), lambda j, g: (0, g, 0))
    col = pl.BlockSpec((None, None, block_kv, D), lambda j, g: (0, g, j, 0))
    dk, dv = kernel_call(
        functools.partial(_varlen_dkdv_kernel, group=group, **kw),
        name="flash_varlen_dkdv",
        grid=(T // block_kv, Hkv),
        in_specs=specs + [grp, col, col, grp, grp_vec, grp_vec],
        out_specs=[col, col],
        out_shape=[jax.ShapeDtypeStruct(k.shape, k.dtype),
                   jax.ShapeDtypeStruct(v.shape, v.dtype)],
    )(*sched, seed_arr, q, k, v, do, lse, delta)
    return dq, dk, dv


# ---------------------------- public wrapper ------------------------------

def _mask_keep_fn(mask_bits):
    """Rebuild a keep_block callable from the hashable mask encoding
    (n_kv_blocks, per-q-block row bitmasks as ints) carried in the
    custom_vjp nondiff meta. None means dense (no filter)."""
    if mask_bits is None:
        return None
    _, rows = mask_bits

    def keep(s, jq, jk):
        return bool((rows[jq] >> jk) & 1)

    return keep


def encode_block_mask(block_mask) -> Tuple[int, Tuple[int, ...]]:
    """Encode a bool [n_q_blocks, n_kv_blocks] array as a hashable
    (n_kv_blocks, row-bitmask-ints) tuple for the custom_vjp meta."""
    m = np.asarray(block_mask, bool)
    assert m.ndim == 2, "block_mask must be [n_q_blocks, n_kv_blocks]"
    rows = tuple(int(sum(1 << j for j in range(m.shape[1]) if m[i, j]))
                 for i in range(m.shape[0]))
    return (int(m.shape[1]), rows)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _varlen_core(meta, q, k, v, seed):
    (o, lse), _ = _varlen_core_fwd(meta, q, k, v, seed)
    return o, lse


def _varlen_core_fwd(meta, q, k, v, seed):
    starts, qlens, kvlens, causal, scale, bq, bkv, dropout_p, mask = meta
    o, lse = flash_attn_varlen_forward(
        q, k, v, np.asarray(starts), qlens, kvlens,
        causal=causal, softmax_scale=scale, block_q=bq, block_kv=bkv,
        dropout_p=dropout_p, seed=seed, keep_block=_mask_keep_fn(mask))
    return (o, lse), (q, k, v, o, lse, seed)


def _varlen_core_bwd(meta, res, cot):
    starts, qlens, kvlens, causal, scale, bq, bkv, dropout_p, mask = meta
    q, k, v, o, lse, seed = res
    do, dlse = cot
    # dlse is the cotangent of the [1, H, T, 1] lse output — already shaped
    # like lse itself.
    dlse4 = jnp.where(jnp.isfinite(lse) & jnp.isfinite(dlse), dlse, 0.0)
    grads = flash_attn_varlen_backward(
        q, k, v, do, o, lse, np.asarray(starts), qlens, kvlens,
        causal=causal, softmax_scale=scale, block_q=bq, block_kv=bkv,
        dropout_p=dropout_p, seed=seed, dlse=dlse4,
        keep_block=_mask_keep_fn(mask))
    return grads + (np.zeros(seed.shape, dtype=jax.dtypes.float0),)


_varlen_core.defvjp(_varlen_core_fwd, _varlen_core_bwd)


def flash_attn_varlen_func(
    q: jax.Array,               # [T, Hq, D] or [1, T, Hq, D] packed tokens
    k: jax.Array,               # [T, Hkv, D]
    v: jax.Array,
    cu_seqlens: Sequence[int],  # [B+1] STATIC packed segment boundaries
    seqlens: Optional[Sequence[int]] = None,  # true lens (default: from cu)
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_rng: Optional[jax.Array] = None,
):
    """Zero-waste varlen attention over a PACKED token stream — the
    reference's varlen mode (`src/forward/caller.py:44-63`) with the packing
    contract made explicit: segment boundaries are static host knowledge
    (fixed-token-budget packing), so
    the kernel index lists contain exactly the blocks that carry real work —
    no programs spent on padding, unlike the lens-clamped
    `attention_mask` path which pays a fixed cost per skipped block.

    `cu_seqlens` are the ALIGNED segment starts (multiples of
    max(block_q, block_kv); see `pack_padded_batch`) plus the total T;
    `seqlens` give each segment's true length (defaults to the full
    aligned extent). Differentiable; segments attend only within
    themselves, causally if requested.
    """
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = (x[None] for x in (q, k, v))
    B = len(cu_seqlens) - 1
    starts = tuple(int(s) for s in cu_seqlens[:-1])
    T = int(cu_seqlens[-1])
    assert q.shape[1] == T, (q.shape, T)
    if seqlens is None:
        seqlens = [int(cu_seqlens[i + 1] - cu_seqlens[i]) for i in range(B)]
    seqlens = tuple(int(l) for l in seqlens)
    D = q.shape[-1]
    scale = (float(softmax_scale) if softmax_scale is not None
             else default_softmax_scale(D))
    align = max(block_q, block_kv)
    assert all(s % align == 0 for s in starts) and T % align == 0, (
        "packed segment starts must be aligned to max(block_q, block_kv); "
        "use pack_padded_batch")

    Dp = head_dim_padded(D)
    out_dtype = q.dtype
    if q.dtype == jnp.float16:
        q, k, v = (x.astype(jnp.float32) for x in (q, k, v))

    def to_bhsd(x):
        x = jnp.transpose(x, (0, 2, 1, 3))
        if Dp != D:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
        return x

    if dropout_p > 0.0:
        if dropout_seed is not None:
            seed = jnp.asarray(dropout_seed, jnp.int32)
        elif dropout_rng is not None:
            seed = jax.random.randint(
                dropout_rng, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32)
        else:
            raise ValueError(
                "dropout_p > 0 requires dropout_seed or dropout_rng "
                "(flash_attn_func's seed contract)."
            )
    else:
        seed = jnp.asarray(
            dropout_seed if dropout_seed is not None else 0, jnp.int32)

    meta = (starts, seqlens, seqlens, causal, scale, block_q, block_kv,
            float(dropout_p), None)
    o, lse = _varlen_core(meta, to_bhsd(q), to_bhsd(k), to_bhsd(v), seed)
    out = jnp.transpose(o[:, :, :, :D], (0, 2, 1, 3)).astype(out_dtype)
    if squeeze:
        out = out[0]
    if return_lse:
        return (out, lse[:, :, :, 0] if not squeeze else lse[0, :, :, 0])
    return out


def flash_attn_blocksparse_func(
    q: jax.Array,               # [B, S, Hq, D]
    k: jax.Array,               # [B, S, Hkv, D]
    v: jax.Array,
    block_mask,                 # STATIC bool [ceil(S/bq), ceil(S/bkv)]
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_rng: Optional[jax.Array] = None,
):
    """Block-sparse attention (BigBird/Longformer/splash-style): softmax runs
    over exactly the (q block, kv block) pairs whose `block_mask` entry is
    True (intersected with the causal lower triangle when `causal`). The
    mask is STATIC host knowledge — like the reference's packing layout —
    so filtered pairs are never visited: the cost
    is proportional to the number of LIVE blocks, not S^2. Shares the
    index-list kernels with `flash_attn_varlen_func` (the reference's varlen
    machinery generalized: a varlen segment layout IS a block mask).

    q rows whose every block is masked out return zeros with lse = -inf and
    propagate zero gradients — same convention as fully-padded rows.
    Differentiable (fwd+bwd), deterministic, GQA via Hq % Hkv == 0.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    assert k.shape == (B, S, Hkv, D) and v.shape == k.shape
    assert Hq % Hkv == 0
    align = max(block_q, block_kv)
    S_pad = round_up_to_multiple(S, align)
    m = np.asarray(block_mask, bool)
    nq_b, nkv_b = S_pad // block_q, S_pad // block_kv
    assert m.shape == (nq_b, nkv_b) or m.shape == (
        (S + block_q - 1) // block_q, (S + block_kv - 1) // block_kv), (
        f"block_mask {m.shape} != ({nq_b}, {nkv_b})")
    if m.shape != (nq_b, nkv_b):   # padded tail blocks: dead anyway
        mm = np.zeros((nq_b, nkv_b), bool)
        mm[:m.shape[0], :m.shape[1]] = m
        m = mm
    scale = (float(softmax_scale) if softmax_scale is not None
             else default_softmax_scale(D))

    out_dtype = q.dtype
    if q.dtype == jnp.float16:
        q, k, v = (x.astype(jnp.float32) for x in (q, k, v))
    Dp = head_dim_padded(D)

    def pack(x):
        # [B, S, H, D] -> packed [1, H, B*S_pad, D] (consecutive segments)
        x = jnp.transpose(x, (0, 2, 1, 3))          # B H S D
        if S_pad != S:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, S_pad - S), (0, 0)))
        if Dp != D:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
        x = jnp.transpose(x, (1, 0, 2, 3))          # H B S D
        return x.reshape(1, x.shape[0], B * S_pad, Dp)

    if dropout_p > 0.0:
        if dropout_seed is not None:
            seed = jnp.asarray(dropout_seed, jnp.int32)
        elif dropout_rng is not None:
            seed = jax.random.randint(
                dropout_rng, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32)
        else:
            raise ValueError(
                "dropout_p > 0 requires dropout_seed or dropout_rng "
                "(flash_attn_func's seed contract).")
    else:
        seed = jnp.asarray(
            dropout_seed if dropout_seed is not None else 0, jnp.int32)

    starts = tuple(b * S_pad for b in range(B))
    lens = (S,) * B
    meta = (starts, lens, lens, causal, scale, block_q, block_kv,
            float(dropout_p), encode_block_mask(m))
    o, lse = _varlen_core(meta, pack(q), pack(k), pack(v), seed)

    def unpack(x):
        # [1, H, B*S_pad, C] -> [B, S, H, C]
        H = x.shape[1]
        x = x.reshape(H, B, S_pad, x.shape[-1])[:, :, :S]
        return jnp.transpose(x, (1, 2, 0, 3))

    out = unpack(o)[..., :D].astype(out_dtype)
    if return_lse:
        return out, unpack(lse)[..., 0].transpose(0, 2, 1)
    return out
