"""FlashAttention-2 backward as two Pallas kernels on the Triton route.

The reference backward (`/root/reference/src/backward/`) written again for
JAX, recomputing attention from the stored base-2 logsumexp:

* a dk/dv kernel: one program per (KV block, batch, KV head), looping over
  the query heads of its GQA group and over the query blocks that can see
  the block, accumulating dk and dv in registers;
* a dq kernel: one program per (q block, batch, q head), looping over the
  KV blocks the rows can see.

Each output block has exactly one owner and no atomics are used, so the
result is bitwise deterministic (the contract `tests/test_repeatability.py`
checks). p = exp2(s*scale*log2e - lse), ds = p * (dp - delta); the softmax
scale multiplies dq and dk once, at the end. delta = rowsum(o * do) -
dlse*log2e is one fused XLA reduction (the reference's `_compute_delta`
kernel), and folds the logsumexp cotangent in. The bias gradient is the
pre-softcap score cotangent, written by the dq kernel as one tile per
visited (q block, KV block) and reduced over the bias' broadcast dims in XLA.
Dropout regenerates the forward's counter-hash mask (`utils/rng.py`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from fa2_jax.ops.flash_fwd import (
    MASK_LOG2,
    dropout_keep,
    keep_mask,
    kv_block_range,
    scores_log2,
)
from fa2_jax.ops.tuning import choose_block_sizes
from fa2_jax.utils import LOG2E, cdiv, dot_precision, kernel_call


def tile_grads(q, k, v, do, lse, delta, bias_tile, keep, drop_keep, *,
               scale, softcap, dropout_p):
    """Recompute one (rows x cols) tile: returns (p_drop, ds, ds_pre).

    `keep` (validity) and `drop_keep` (dropout) are bool tiles or None.
    p_drop feeds dv, ds (the natural-score cotangent, softcap derivative
    applied, softmax scale NOT applied) feeds dq and dk, and ds_pre is the
    cotangent of the post-softcap, post-bias score — the bias gradient.
    `lse` must be +inf on dead rows so their p is exactly 0."""
    s2, capped = scores_log2(q, k, bias_tile, scale=scale, softcap=softcap,
                             prescaled=False)
    if keep is not None:
        s2 = jnp.where(keep, s2, MASK_LOG2)
    p = jnp.exp2(s2 - lse[:, None])
    dp = pl.dot(do, v, trans_b=True, precision=dot_precision(do, v))
    if drop_keep is not None:
        inv = 1.0 / (1.0 - dropout_p)
        p_drop = jnp.where(drop_keep, p * inv, 0.0)
        dp = jnp.where(drop_keep, dp * inv, 0.0)
    else:
        p_drop = p
    ds_pre = p * (dp - delta[:, None])
    ds = ds_pre * (1.0 - (capped / softcap) ** 2) if softcap > 0.0 else ds_pre
    return p_drop, ds, ds_pre


def _tile_masks(rows, cols, *, seed, b, h, kv_len, shift, masked, causal,
                window, dropout_p, num_q_heads, seqlen_q_real, seqlen_k_real,
                **_):
    keep = (keep_mask(rows[:, None], cols[None, :], kv_len=kv_len,
                      shift=shift, causal=causal, window=window)
            if masked else None)
    drop_keep = None
    if dropout_p > 0.0:
        drop_keep = dropout_keep(seed, b, h, rows[:, None], cols[None, :],
                                 num_q_heads=num_q_heads,
                                 seqlen_q_real=seqlen_q_real,
                                 seqlen_k_real=seqlen_k_real,
                                 dropout_p=dropout_p)
    return keep, drop_keep


def _dq_kernel(lens_ref, scal_ref, q_ref, k_ref, v_ref, do_ref, lse_ref,
               delta_ref, *refs, block_q, block_kv, num_kv_blocks, has_bias,
               **kw):
    bias_ref = dbias_in = dbias_ref = None
    if has_bias:
        bias_ref, dbias_in, dq_ref, dbias_ref = refs
    else:
        (dq_ref,) = refs
    del dbias_in  # zeros aliased to dbias_ref: unvisited tiles stay zero
    iq, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    q_len, kv_len = lens_ref[0], lens_ref[1]
    q_off, kv_off, seed = scal_ref[0], scal_ref[1], scal_ref[2]
    shift = kv_len - q_len
    row_lo = q_off + iq * block_q
    rows = row_lo + jnp.arange(block_q, dtype=jnp.int32)
    q, do = q_ref[...], do_ref[...]
    lse, delta = lse_ref[...], delta_ref[...]

    def body(j, acc, masked):
        start = pl.multiple_of(j * block_kv, block_kv)
        k = k_ref[pl.ds(start, block_kv), :]
        v = v_ref[pl.ds(start, block_kv), :]
        cols = kv_off + start + jnp.arange(block_kv, dtype=jnp.int32)
        bias_tile = (None if bias_ref is None
                     else bias_ref[:, pl.ds(start, block_kv)])
        keep, drop_keep = _tile_masks(rows, cols, seed=seed, b=b, h=h,
                                      kv_len=kv_len, shift=shift,
                                      masked=masked, **kw)
        _, ds, ds_pre = tile_grads(
            q, k, v, do, lse, delta, bias_tile, keep, drop_keep,
            scale=kw["scale"], softcap=kw["softcap"],
            dropout_p=kw["dropout_p"])
        if dbias_ref is not None:
            dbias_ref[:, pl.ds(start, block_kv)] = ds_pre
        return acc + pl.dot(ds.astype(k.dtype), k, precision=dot_precision(k))

    lo, full_lo, full_hi, hi = kv_block_range(
        row_lo, row_lo + block_q - 1, q_len=q_len, kv_len=kv_len,
        kv_off=kv_off, block_kv=block_kv, num_kv_blocks=num_kv_blocks,
        causal=kw["causal"], window=kw["window"])
    masked_body = functools.partial(body, masked=True)
    acc = jnp.zeros(q_ref.shape, jnp.float32)
    acc = lax.fori_loop(lo, full_lo, masked_body, acc)
    acc = lax.fori_loop(full_lo, full_hi,
                        functools.partial(body, masked=False), acc)
    acc = lax.fori_loop(full_hi, hi, masked_body, acc)
    dq_ref[...] = (acc * kw["scale"]).astype(dq_ref.dtype)


def q_block_range(col_lo, col_hi, *, q_len, kv_len, q_off, block_q,
                  num_q_blocks, causal, window):
    """Query blocks that see KV columns [col_lo, col_hi] (global), split
    like `kv_block_range`: (lo, full_lo, full_hi, hi)."""
    shift = kv_len - q_len
    lo = jnp.int32(0)
    full_lo = jnp.int32(0)
    hi = jnp.clip(cdiv(q_len - q_off, block_q), 0, num_q_blocks)
    full_hi = hi
    if causal or window[1] >= 0:
        right = 0 if causal else window[1]
        lo = jnp.clip((col_lo - shift - right - q_off) // block_q, 0,
                      num_q_blocks)
        full_lo = jnp.clip(cdiv(col_hi - shift - right - q_off, block_q), 0,
                           num_q_blocks)
    if window[0] >= 0:
        hi = jnp.minimum(hi, jnp.clip(
            (col_hi - shift + window[0] - q_off) // block_q + 1, 0,
            num_q_blocks))
        full_hi = jnp.clip(
            (col_lo - shift + window[0] - q_off + 1) // block_q, 0,
            num_q_blocks)
    # A block with padded columns is never mask-free; a dead one is skipped.
    hi = jnp.where(col_lo < kv_len, hi, 0)
    full_hi = jnp.where(col_hi < kv_len, full_hi, 0)
    lo = jnp.minimum(lo, hi)
    full_lo = jnp.clip(full_lo, lo, hi)
    full_hi = jnp.clip(full_hi, full_lo, hi)
    return lo, full_lo, full_hi, hi


def _dkdv_kernel(lens_ref, scal_ref, q_ref, k_ref, v_ref, do_ref, lse_ref,
                 delta_ref, *refs, block_q, block_kv, num_q_blocks, group,
                 has_bias, bias_per_head, **kw):
    if has_bias:
        bias_ref, dk_ref, dv_ref = refs
    else:
        bias_ref = None
        dk_ref, dv_ref = refs
    ik, b, hkv = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    q_len, kv_len = lens_ref[0], lens_ref[1]
    q_off, kv_off, seed = scal_ref[0], scal_ref[1], scal_ref[2]
    shift = kv_len - q_len
    col_lo = kv_off + ik * block_kv
    cols = col_lo + jnp.arange(block_kv, dtype=jnp.int32)
    k, v = k_ref[...], v_ref[...]

    def body(i, carry, g, masked):
        dk, dv = carry
        start = pl.multiple_of(i * block_q, block_q)
        q = q_ref[g, pl.ds(start, block_q), :]
        do = do_ref[g, pl.ds(start, block_q), :]
        lse = lse_ref[g, pl.ds(start, block_q)]
        delta = delta_ref[g, pl.ds(start, block_q)]
        rows = q_off + start + jnp.arange(block_q, dtype=jnp.int32)
        bias_tile = (None if bias_ref is None else
                     bias_ref[g if bias_per_head else 0,
                              pl.ds(start, block_q), :])
        keep, drop_keep = _tile_masks(rows, cols, seed=seed, b=b,
                                      h=hkv * group + g, kv_len=kv_len,
                                      shift=shift, masked=masked, **kw)
        p_drop, ds, _ = tile_grads(
            q, k, v, do, lse, delta, bias_tile, keep, drop_keep,
            scale=kw["scale"], softcap=kw["softcap"],
            dropout_p=kw["dropout_p"])
        dv = dv + pl.dot(p_drop.astype(do.dtype), do, trans_a=True,
                         precision=dot_precision(do))
        dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True,
                         precision=dot_precision(q))
        return dk, dv

    lo, full_lo, full_hi, hi = q_block_range(
        col_lo, col_lo + block_kv - 1, q_len=q_len, kv_len=kv_len,
        q_off=q_off, block_q=block_q, num_q_blocks=num_q_blocks,
        causal=kw["causal"], window=kw["window"])

    def head(g, carry):
        masked_body = functools.partial(body, g=g, masked=True)
        carry = lax.fori_loop(lo, full_lo, masked_body, carry)
        carry = lax.fori_loop(
            full_lo, full_hi, functools.partial(body, g=g, masked=False),
            carry)
        return lax.fori_loop(full_hi, hi, masked_body, carry)

    zeros = jnp.zeros(k_ref.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, group, head, (zeros, zeros))
    dk_ref[...] = (dk * kw["scale"]).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def flash_attn_backward(
    q, k, v, do, o, lse,        # BHSD padded; lse [B, Hq, Sq, 1] f32 (base-2)
    lens, scalars, bias,
    *,
    causal: bool,
    softmax_scale: float,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    seqlen_q_real: Optional[int] = None,
    seqlen_k_real: Optional[int] = None,
    dlse: Optional[jax.Array] = None,   # cotangent of the base-2 LSE output
    compute_dbias: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    num_warps: Optional[int] = None,
    num_stages: Optional[int] = None,
):
    """Returns (dq, dk, dv) in input dtypes, deterministic by construction.

    `dlse` propagates the logsumexp cotangent: with L the natural-log LSE and
    lse2 = L*log2e the emitted value, d(loss)/ds_ij picks up an extra
    p_ij * dL_i term, so the whole contribution folds into the delta row
    statistic: delta_eff = rowsum(o*do) - dlse*log2e (the reference drops
    this gradient entirely — its LSE output is test-only).

    `compute_dbias=True` (requires bias) appends the bias gradient in the
    bias' own broadcast shape: (dq, dk, dv, dbias).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    blocks = choose_block_sizes(Sq, Sk, D, dtype_bits=q.dtype.itemsize * 8)
    block_q = block_q or blocks.block_q_bwd
    block_kv = block_kv or blocks.block_kv_bwd
    assert Sq % block_q == 0 and Sk % block_kv == 0, (Sq, Sk, block_q, block_kv)
    num_warps = num_warps or blocks.num_warps_bwd
    num_stages = num_stages or blocks.num_stages_bwd

    lse = lse[..., 0]
    delta = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32), axis=-1)
    if dlse is not None:
        # Dead rows carry lse == -inf; their (zero) cotangent must not poison
        # delta with inf/nan, so gate on finiteness of both.
        dlse = dlse.reshape(lse.shape)
        safe = jnp.logical_and(jnp.isfinite(lse), jnp.isfinite(dlse))
        delta = delta - jnp.where(safe, dlse, 0.0) * LOG2E
    # Dead rows (lse == -inf) get +inf so exp2(s - lse) is exactly 0 there.
    lse = jnp.where(jnp.isfinite(lse), lse, jnp.inf)
    lens = lens.astype(jnp.int32)
    scalars = scalars.astype(jnp.int32)

    common = dict(
        scale=softmax_scale, causal=causal, window=tuple(window),
        softcap=softcap, dropout_p=dropout_p, num_q_heads=Hq,
        seqlen_q_real=seqlen_q_real or Sq, seqlen_k_real=seqlen_k_real or Sk)
    lens_spec = pl.BlockSpec((None, 2), lambda i, b, h: (b, 0))
    scal_spec = pl.BlockSpec((None, 4), lambda i, b, h: (0, 0))
    has_bias = bias is not None
    if compute_dbias:
        assert has_bias, "compute_dbias requires a bias"

    # ---------------- dq: one program per (q block, b, h) ---------------
    row_spec = pl.BlockSpec((None, None, block_q, D), lambda i, b, h: (b, h, i, 0))
    kv_full = pl.BlockSpec((None, None, Sk, D), lambda i, b, h: (b, h // group, 0, 0))
    vec_spec = pl.BlockSpec((None, None, block_q), lambda i, b, h: (b, h, i))
    in_specs = [lens_spec, scal_spec, row_spec, kv_full, kv_full, row_spec,
                vec_spec, vec_spec]
    args = [lens, scalars, q, k, v, do, lse, delta]
    out_specs = [row_spec]
    out_shape = [jax.ShapeDtypeStruct(q.shape, q.dtype)]
    aliases = {}
    if has_bias:
        Bb, Hb = bias.shape[:2]
        in_specs.append(pl.BlockSpec(
            (None, None, block_q, Sk),
            lambda i, b, h: (b if Bb > 1 else 0, h if Hb > 1 else 0, i, 0)))
        args.append(bias)
        # Every dq program owns its rows of the full [B, Hq, Sq, Sk] score
        # cotangent; tiles it never visits keep the aliased zeros.
        ds_spec = pl.BlockSpec((None, None, block_q, Sk),
                               lambda i, b, h: (b, h, i, 0))
        in_specs.append(ds_spec)
        args.append(jnp.zeros((B, Hq, Sq, Sk), jnp.float32))
        aliases = {len(args) - 1: 1}
        out_specs.append(ds_spec)
        out_shape.append(jax.ShapeDtypeStruct((B, Hq, Sq, Sk), jnp.float32))
    outs = kernel_call(
        functools.partial(_dq_kernel, block_q=block_q, block_kv=block_kv,
                          num_kv_blocks=Sk // block_kv, has_bias=has_bias,
                          **common),
        name="flash_bwd_dq", num_warps=num_warps, num_stages=num_stages,
        grid=(Sq // block_q, B, Hq),
        in_specs=in_specs, out_specs=out_specs, out_shape=out_shape,
        input_output_aliases=aliases,
    )(*args)
    dq = outs[0]

    # ------------- dk/dv: one program per (kv block, b, kv head) --------
    grp_spec = pl.BlockSpec((None, group, Sq, D), lambda j, b, g: (b, g, 0, 0))
    grp_vec = pl.BlockSpec((None, group, Sq), lambda j, b, g: (b, g, 0))
    col_spec = pl.BlockSpec((None, None, block_kv, D), lambda j, b, g: (b, g, j, 0))
    in_specs = [lens_spec, scal_spec, grp_spec, col_spec, col_spec, grp_spec,
                grp_vec, grp_vec]
    args = [lens, scalars, q, k, v, do, lse, delta]
    bias_per_head = False
    if has_bias:
        bias_per_head = Hb > 1
        in_specs.append(pl.BlockSpec(
            (None, group if bias_per_head else 1, Sq, block_kv),
            lambda j, b, g: (b if Bb > 1 else 0, g if bias_per_head else 0,
                             0, j)))
        args.append(bias)
    dk, dv = kernel_call(
        functools.partial(_dkdv_kernel, block_q=block_q, block_kv=block_kv,
                          num_q_blocks=Sq // block_q, group=group,
                          has_bias=has_bias, bias_per_head=bias_per_head,
                          **common),
        name="flash_bwd_dkdv", num_warps=num_warps, num_stages=num_stages,
        grid=(Sk // block_kv, B, Hkv),
        in_specs=in_specs, out_specs=[col_spec, col_spec],
        out_shape=[jax.ShapeDtypeStruct(k.shape, k.dtype),
                   jax.ShapeDtypeStruct(v.shape, v.dtype)],
    )(*args)

    if compute_dbias:
        ds = outs[1]
        axes = tuple(ax for ax, n in ((0, Bb), (1, Hb)) if n == 1)
        dbias = jnp.sum(ds, axis=axes, keepdims=True) if axes else ds
        return dq, dk, dv, dbias.astype(bias.dtype)
    return dq, dk, dv
