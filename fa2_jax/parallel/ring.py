"""Ring (sequence-parallel) attention for long context — fwd AND bwd.

New scale-out surface the reference lacks (SURVEY.md §5.7): the KV sequence
is sharded over the mesh's `seq` axis; each device computes its query shard
against the KV shard it currently holds while `ppermute` rotates K/V around
the ring, and the per-chunk partials are merged with the SAME associative
online-softmax rule the kernel uses internally
(`compute_row_blocks.py:71-101` in the reference is the mathematical
contract): each chunk returns a normalized output plus base-2 LSE, and

    m'   = max(m, lse_c)
    acc' = acc * exp2(m - m') + o_c * exp2(lse_c - m')
    l'   = l   * exp2(m - m') +        exp2(lse_c - m')

recovers the exact full-sequence softmax.

Causal load balance — the ZIGZAG layout: with contiguous shards, device 0
computes 1 chunk while device n-1 computes n (the ring's wall-clock is the
slowest device). Instead the sequence is split into 2n chunks and device i
holds the PAIR (i, 2n-1-i): of the four (q-half, kv-half) chunk pairs per
hop, almost exactly two are causally needed on every device at every step —
constant work, ~2x faster causal rings. The kernel reads each chunk's global
offsets, so diagonal pairs mask only their diagonal blocks and strictly-past
pairs run mask-free.

Backward (training): once the forward has the GLOBAL base-2 LSE per query
row, the FA2 recompute decomposes per chunk pair, so

  * dq_i accumulates locally over the KV chunks as they pass by, and
  * (k_j, v_j, dk_j, dv_j) travel the ring TOGETHER: every device adds its
    local (q_i, do_i, lse_i, delta_i) contribution to the resident chunk's
    dk/dv, and after n hops the accumulators arrive home complete —
    deterministic, no collective reductions beyond the ppermute ring.

The LSE output is differentiable: its cotangent folds into every chunk's
delta statistic (see `flash_attn_backward(dlse=...)`), and dropout /
sliding windows thread through to the kernels on global positions (the
dropout counter stream is identical to the single-device kernel's, so a
ring forward is bitwise-reproducible against one device).

Constraint: the local shard must split into two block-aligned zigzag chunks
(S_local % 256 == 0 for the causal zigzag layout; S_local % 128 == 0 for
non-causal rings; 128 is the largest kernel block).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from fa2_jax.ops.flash_bwd import flash_attn_backward
from fa2_jax.ops.flash_fwd import MASK_LOG2, flash_attn_forward
from fa2_jax.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ
from fa2_jax.utils import (
    LOG2E,
    default_softmax_scale,
    head_dim_padded,
    pad_to_multiple,
)


@dataclass(frozen=True)
class RingConfig:
    axis_name: str
    causal: bool
    softmax_scale: Optional[float]
    window: Tuple[int, int] = (-1, -1)
    dropout_p: float = 0.0
    # Zigzag chunk layout (causal only): device i holds chunks (i, 2n-1-i)
    # of 2n; the host-side make_ring_attention permutes/unpermutes.
    zigzag: bool = False


def _merge(m, l, acc, o_c, lse_c):
    m_new = jnp.maximum(m, lse_c)
    w_old = jnp.exp2(m - m_new)
    w_c = jnp.exp2(lse_c - m_new)
    acc = acc * w_old + o_c.astype(jnp.float32) * w_c
    l = l * w_old + w_c
    return m_new, l, acc


def _to_bhsd(x):
    return jnp.transpose(x, (0, 2, 1, 3))


def _from_bhsd(x):
    return jnp.transpose(x, (0, 2, 1, 3))


def _scalars(q_off, kv_off, seed):
    return jnp.stack(
        [jnp.asarray(q_off, jnp.int32), jnp.asarray(kv_off, jnp.int32),
         jnp.asarray(seed, jnp.int32), jnp.int32(0)]
    ).reshape(1, 4)


def _resolve_seed(dropout_p, dropout_seed, dropout_rng):
    """Mirror `flash_attn_func`'s raise-if-missing dropout seed contract
    (`ops/attention.py`): a pure function cannot draw the reference's
    per-call random seed, and a silent fixed default would reuse one dropout
    mask across every layer and step."""
    if dropout_p > 0.0:
        if dropout_seed is not None:
            return jnp.asarray(dropout_seed, jnp.int32)
        if dropout_rng is not None:
            return jax.random.randint(
                dropout_rng, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32)
        raise ValueError(
            "dropout_p > 0 requires dropout_seed or dropout_rng (ring "
            "attention shares flash_attn_func's seed contract; a baked-in "
            "seed would repeat the same dropout mask every layer and step)."
        )
    return jnp.asarray(dropout_seed if dropout_seed is not None else 0,
                       jnp.int32)


def zigzag_permute(x: jax.Array, n: int, axis: int = 1) -> jax.Array:
    """Reorder a global sequence so a contiguous `seq`-sharding gives device
    i the chunk pair (i, 2n-1-i) of 2n equal chunks."""
    S = x.shape[axis]
    assert S % (2 * n) == 0, f"seqlen {S} must divide into 2*{n} chunks"
    chunks = jnp.split(x, 2 * n, axis=axis)
    out = []
    for i in range(n):
        out += [chunks[i], chunks[2 * n - 1 - i]]
    return jnp.concatenate(out, axis=axis)


def zigzag_unpermute(x: jax.Array, n: int, axis: int = 1) -> jax.Array:
    S = x.shape[axis]
    parts = jnp.split(x, 2 * n, axis=axis)
    out = [None] * (2 * n)
    for i in range(n):
        out[i] = parts[2 * i]
        out[2 * n - 1 - i] = parts[2 * i + 1]
    return jnp.concatenate(out, axis=axis)


def _chunk_call_fwd(cfg, scale, seed, S_tot, qT, k_c, v_c, q_off, kv_off):
    """One (q-half, kv-half) kernel call on global offsets; returns
    (o_c, lse_c). Global extents: the dropout counter stream and mask
    positions are global."""
    B = qT.shape[0]
    lens = jnp.broadcast_to(jnp.array([[S_tot, S_tot]], jnp.int32), (B, 2))
    return flash_attn_forward(
        qT, k_c, v_c, lens, _scalars(q_off, kv_off, seed), None,
        causal=cfg.causal, softmax_scale=scale, window=cfg.window,
        dropout_p=cfg.dropout_p,
        seqlen_q_real=S_tot, seqlen_k_real=S_tot, q_prescaled=True,
    )


def _needed(cfg, q_chunk, kv_chunk, C, n):
    """Is chunk pair (q_chunk, kv_chunk) inside the mask band?"""
    need = jnp.bool_(True)
    if cfg.causal:
        need = kv_chunk <= q_chunk
    if cfg.window[0] >= 0:
        # kv chunk ends before the window's left edge -> skip.
        need = jnp.logical_and(
            need, (kv_chunk + 1) * C - 1 >= q_chunk * C - cfg.window[0])
    if cfg.window[1] >= 0 and not cfg.causal:
        need = jnp.logical_and(
            need, kv_chunk * C <= (q_chunk + 1) * C - 1 + cfg.window[1])
    return need


def _halves(cfg, x, n, idx):
    """Split local BHSD tensor into zigzag halves with global chunk ids."""
    if not cfg.zigzag:
        return [(x, idx)], x.shape[2]
    C = x.shape[2] // 2
    return [(x[:, :, :C], idx), (x[:, :, C:], 2 * n - 1 - idx)], C


def _ring_forward_impl(cfg: RingConfig, q, k, v, seed=0):
    """Per-shard forward. Returns (out BSHD, lse [B, Hq, S_loc, 1] f32)."""
    B, S_loc, Hq, D = q.shape
    assert S_loc % 128 == 0, "ring shards must be block-aligned"
    n = jax.lax.axis_size(cfg.axis_name)
    idx = jax.lax.axis_index(cfg.axis_name)
    scale = (cfg.softmax_scale if cfg.softmax_scale is not None
             else default_softmax_scale(D))
    S_tot = n * S_loc

    Dp = head_dim_padded(D)
    qT = pad_to_multiple(_to_bhsd(q), Dp, 3)
    kT = pad_to_multiple(_to_bhsd(k), Dp, 3)
    vT = pad_to_multiple(_to_bhsd(v), Dp, 3)
    # Hoist the scale*log2e fold out of the per-chunk loop.
    qT = (qT.astype(jnp.float32) * (scale * LOG2E)).astype(qT.dtype)

    q_halves, C = _halves(cfg, qT, n, idx)
    states = [
        (jnp.full((B, Hq, C, 1), MASK_LOG2, jnp.float32),
         jnp.zeros((B, Hq, C, 1), jnp.float32),
         jnp.zeros((B, Hq, C, Dp), jnp.float32))
        for _ in q_halves
    ]

    perm = [(i, (i + 1) % n) for i in range(n)]
    k_cur, v_cur = kT, vT
    for step in range(n):
        # Prefetch the next hop's KV BEFORE computing this hop: the permute
        # reads only k_cur/v_cur, and nothing below depends on k_nxt/v_nxt,
        # so XLA can run the transfer concurrently with the kernels.
        if step != n - 1:
            k_nxt = jax.lax.ppermute(k_cur, cfg.axis_name, perm)
            v_nxt = jax.lax.ppermute(v_cur, cfg.axis_name, perm)
        src = (idx - step) % n
        kv_halves, _ = _halves(cfg, k_cur, n, src)
        v_halves, _ = _halves(cfg, v_cur, n, src)
        for qi, (q_h, qc) in enumerate(q_halves):
            for (k_h, kc), (v_h, _) in zip(kv_halves, v_halves):
                def _do(ops, q_h=q_h, k_h=k_h, v_h=v_h, qc=qc, kc=kc):
                    m, l, acc = ops
                    o_c, lse_c = _chunk_call_fwd(
                        cfg, scale, seed, S_tot, q_h, k_h, v_h, qc * C,
                        kc * C)
                    return _merge(m, l, acc, o_c, lse_c)

                states[qi] = jax.lax.cond(
                    _needed(cfg, qc, kc, C, n), _do, lambda ops: ops,
                    states[qi])
        if step != n - 1:
            k_cur, v_cur = k_nxt, v_nxt

    os, lses = [], []
    for m, l, acc in states:
        l_inv = jnp.where(l > 0.0, 1.0 / l, 0.0)
        os.append((acc * l_inv).astype(q.dtype))
        lses.append(m + jnp.log2(jnp.maximum(l, 0.0)))  # -inf on dead rows
    o = jnp.concatenate(os, axis=2) if len(os) > 1 else os[0]
    lse = jnp.concatenate(lses, axis=2) if len(lses) > 1 else lses[0]
    return _from_bhsd(o[:, :, :, :D]), lse


def _ring_backward_impl(cfg: RingConfig, q, k, v, out, lse, do, dlse=None,
                        seed=0):
    """Per-shard backward. dq stays local; (k, v, dk, dv) ride the ring."""
    B, S_loc, Hq, D = q.shape
    n = jax.lax.axis_size(cfg.axis_name)
    idx = jax.lax.axis_index(cfg.axis_name)
    scale = (cfg.softmax_scale if cfg.softmax_scale is not None
             else default_softmax_scale(D))
    S_tot = n * S_loc

    Dp = head_dim_padded(D)
    qT = pad_to_multiple(_to_bhsd(q), Dp, 3)
    kT = pad_to_multiple(_to_bhsd(k), Dp, 3)
    vT = pad_to_multiple(_to_bhsd(v), Dp, 3)
    oT = pad_to_multiple(_to_bhsd(out), Dp, 3)
    doT = pad_to_multiple(_to_bhsd(do), Dp, 3)

    q_halves, C = _halves(cfg, qT, n, idx)
    o_halves, _ = _halves(cfg, oT, n, idx)
    do_halves, _ = _halves(cfg, doT, n, idx)
    lse_halves, _ = _halves(cfg, lse, n, idx)
    dlse_halves = (_halves(cfg, dlse, n, idx)[0]
                   if dlse is not None else [(None, 0)] * len(q_halves))

    dq_halves = [jnp.zeros((B, Hq, C, Dp), jnp.float32) for _ in q_halves]
    # Communication/compute overlap ("lag-one" accumulators): the traveling
    # dk/dv accumulators run ONE HOP BEHIND their kv chunk. Each hop folds the
    # PREVIOUS hop's local contribution (already computed) into the arriving
    # accumulator and forwards it immediately — so the ppermute has no data
    # dependence on this hop's kernels and rides the link concurrently with
    # them. KV prefetch works the same way. After the loop, the final hop's
    # contribution is folded locally and one last permute delivers each
    # accumulator home (same n total hops and identical fold order as the
    # serialized schedule, so numerics are unchanged).
    acc_dk = jnp.zeros_like(kT, jnp.float32)
    acc_dv = jnp.zeros_like(vT, jnp.float32)

    perm = [(i, (i + 1) % n) for i in range(n)]
    k_cur, v_cur = kT, vT
    for step in range(n):
        if step > 0:
            acc_dk = jax.lax.ppermute(acc_dk + pend_dk, cfg.axis_name, perm)
            acc_dv = jax.lax.ppermute(acc_dv + pend_dv, cfg.axis_name, perm)
        if step != n - 1:
            k_nxt = jax.lax.ppermute(k_cur, cfg.axis_name, perm)
            v_nxt = jax.lax.ppermute(v_cur, cfg.axis_name, perm)
        pend_dk = jnp.zeros_like(kT, jnp.float32)
        pend_dv = jnp.zeros_like(vT, jnp.float32)
        src = (idx - step) % n
        kv_halves, _ = _halves(cfg, k_cur, n, src)
        v_halves, _ = _halves(cfg, v_cur, n, src)
        for qi, (q_h, qc) in enumerate(q_halves):
            for kj, ((k_h, kc), (v_h, _)) in enumerate(
                    zip(kv_halves, v_halves)):

                def _do(ops, q_h=q_h, k_h=k_h, v_h=v_h, qc=qc, kc=kc,
                        qi=qi, kj=kj):
                    dq_h, pend_dk, pend_dv = ops

                    dq_c, dk_c, dv_c = _bwd_pair(
                        cfg, scale, seed, S_tot, q_h, k_h, v_h,
                        do_halves[qi][0], o_halves[qi][0],
                        lse_halves[qi][0], dlse_halves[qi][0],
                        qc * C, kc * C)
                    dq_h = dq_h + dq_c.astype(jnp.float32)
                    ksl = slice(kj * C, (kj + 1) * C) if cfg.zigzag else \
                        slice(None)
                    pend_dk = pend_dk.at[:, :, ksl].add(
                        dk_c.astype(jnp.float32))
                    pend_dv = pend_dv.at[:, :, ksl].add(
                        dv_c.astype(jnp.float32))
                    return dq_h, pend_dk, pend_dv

                dq_halves[qi], pend_dk, pend_dv = jax.lax.cond(
                    _needed(cfg, qc, kc, C, n), _do,
                    lambda ops: ops, (dq_halves[qi], pend_dk, pend_dv))

        if step != n - 1:
            k_cur, v_cur = k_nxt, v_nxt

    # Fold the last hop's contribution and deliver each accumulator home.
    dk_t = jax.lax.ppermute(acc_dk + pend_dk, cfg.axis_name, perm)
    dv_t = jax.lax.ppermute(acc_dv + pend_dv, cfg.axis_name, perm)

    dq = (jnp.concatenate(dq_halves, axis=2) if len(dq_halves) > 1
          else dq_halves[0])
    dq_out = _from_bhsd(dq[:, :, :, :D]).astype(q.dtype)
    dk_out = _from_bhsd(dk_t[:, :, :, :D]).astype(k.dtype)
    dv_out = _from_bhsd(dv_t[:, :, :, :D]).astype(v.dtype)
    return dq_out, dk_out, dv_out


def _bwd_pair(cfg, scale, seed, S_tot, qT, k_c, v_c, doT, oT, lse, dlse,
              q_off, kv_off):
    B = qT.shape[0]
    lens = jnp.broadcast_to(jnp.array([[S_tot, S_tot]], jnp.int32), (B, 2))
    return flash_attn_backward(
        qT, k_c, v_c, doT, oT, lse, lens,
        _scalars(q_off, kv_off, seed), None,
        causal=cfg.causal, softmax_scale=scale, window=cfg.window,
        dropout_p=cfg.dropout_p,
        seqlen_q_real=S_tot, seqlen_k_real=S_tot, dlse=dlse,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _ring_attn(cfg: RingConfig, q, k, v, seed):
    out, lse = _ring_forward_impl(cfg, q, k, v, seed=seed)
    return out, lse[:, :, :, 0]


def _ring_attn_fwd(cfg, q, k, v, seed):
    out, lse = _ring_forward_impl(cfg, q, k, v, seed=seed)
    return (out, lse[:, :, :, 0]), (q, k, v, out, lse, seed)


def _ring_attn_bwd(cfg, res, cot):
    import numpy as np

    q, k, v, out, lse, seed = res
    do, dlse = cot
    # Guard non-finite rows (dead-row lse is -inf; cotangent must not leak).
    dlse4 = dlse[:, :, :, None]
    dlse4 = jnp.where(jnp.isfinite(lse) & jnp.isfinite(dlse4), dlse4, 0.0)
    dq, dk, dv = _ring_backward_impl(cfg, q, k, v, out, lse, do, dlse=dlse4,
                                     seed=seed)
    return dq, dk, dv, np.zeros(seed.shape, dtype=jax.dtypes.float0)


_ring_attn.defvjp(_ring_attn_fwd, _ring_attn_bwd)


def ring_attention_local(
    q: jax.Array,   # [B, S_loc, Hq, D] local shard
    k: jax.Array,   # [B, S_loc, Hkv, D]
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool,
    softmax_scale: Optional[float] = None,
    window: Tuple[int, int] = (-1, -1),
    dropout_p: float = 0.0,
    zigzag: bool = False,
    return_lse: bool = False,
    dropout_seed=None,
    dropout_rng: Optional[jax.Array] = None,
):
    """Differentiable per-shard ring attention; run inside shard_map.

    With zigzag=True the local shard must already hold the zigzag chunk
    pair layout (use `make_ring_attention`, which permutes globally).

    `dropout_seed` may be a Python int or a traced int32 scalar (it must be
    identical on every ring device — derive it OUTSIDE shard_map or from a
    replicated key); with dropout_p > 0, exactly one of dropout_seed /
    dropout_rng is required, like `flash_attn_func`."""
    cfg = RingConfig(axis_name=axis_name, causal=causal,
                     softmax_scale=softmax_scale, window=window,
                     dropout_p=dropout_p, zigzag=zigzag)
    seed = _resolve_seed(dropout_p, dropout_seed, dropout_rng)
    out, lse = _ring_attn(cfg, q, k, v, seed)
    if return_lse:
        return out, lse
    return out


def make_ring_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    seq_axis: str = AXIS_SEQ,
    window: Tuple[int, int] = (-1, -1),
    dropout_p: float = 0.0,
    zigzag: Optional[bool] = None,
    return_lse: bool = False,
    dropout_seed=None,
):
    """Returns differentiable fn(q, k, v, dropout_rng=None) over GLOBAL
    [B, S, H, D] arrays sharded (data, seq, model, None). Causal rings
    default to the zigzag layout (balanced work per device); the permutation
    is applied/undone here on the global arrays, so callers see normal
    sequence order.

    Dropout follows `flash_attn_func`'s seed contract: with dropout_p > 0,
    give `dropout_seed` here (int or int32 scalar) or pass a `jax.random`
    key per call as `dropout_rng` (fold in step/layer for training loops).
    The seed is derived once on the global side and broadcast to every ring
    device, so the counter stream matches the single-device kernel's."""
    n = int(mesh.shape[seq_axis])
    spec = P(AXIS_DATA, seq_axis, AXIS_MODEL, None)
    lse_spec = P(AXIS_DATA, AXIS_MODEL, seq_axis)

    def fn(q, k, v, dropout_rng=None):
        S = q.shape[1]
        # Zigzag needs two block-aligned chunks per device; otherwise fall
        # back to the contiguous layout (still correct, less balanced).
        zz_ok = S % (2 * n) == 0 and (S // (2 * n)) % 128 == 0
        use_zigzag = (causal and n > 1 and zz_ok) if zigzag is None \
            else (zigzag and zz_ok)
        seed = _resolve_seed(dropout_p, dropout_seed, dropout_rng)

        def local_fn(q, k, v, seed):
            return ring_attention_local(
                q, k, v, axis_name=seq_axis, causal=causal,
                softmax_scale=softmax_scale, window=window,
                dropout_p=dropout_p, zigzag=use_zigzag, return_lse=True,
                dropout_seed=seed,
            )

        sharded = jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(spec, spec, spec, P()),
            out_specs=(spec, lse_spec),
            check_vma=False,  # pallas_call outputs cannot carry vma annotations
        )
        if use_zigzag:
            q, k, v = (zigzag_permute(x, n, axis=1) for x in (q, k, v))
        out, lse = sharded(q, k, v, seed)
        if use_zigzag:
            out = zigzag_unpermute(out, n, axis=1)
            lse = zigzag_unpermute(lse, n, axis=2)
        if return_lse:
            return out, lse
        return out

    return fn
