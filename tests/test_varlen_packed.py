"""Packed (zero-waste) varlen attention (`ops/varlen.py`): parity with the
oracle per segment, exact zeros on padded positions (incl. gradients), and
the work-list schedule's block accounting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax import (
    flash_attn_reference,
    flash_attn_varlen_func,
    pack_padded_batch,
    unpack_padded_batch,
)
from fa2_jax.ops.varlen import _build_schedule, _seg_extents


def _err(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def _make(B, S, Hq, Hkv, D, lens, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(ks[0], (B, S, Hq, D), jnp.float32) * 0.5
    k = jax.random.normal(ks[1], (B, S, Hkv, D), jnp.float32) * 0.5
    v = jax.random.normal(ks[2], (B, S, Hkv, D), jnp.float32) * 0.5
    do = jax.random.normal(ks[3], (B, S, Hq, D), jnp.float32) * 0.5
    # Zero padded tails so packing/unpacking comparisons are exact.
    keep = (jnp.arange(S)[None, :, None, None]
            < jnp.asarray(lens)[:, None, None, None])
    return (q * keep, k * keep, v * keep, do * keep)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens,blocks", [
    ((300, 512, 129), (256, 256)),
    ((512, 1, 200), (256, 256)),
    ((300, 512, 129), (128, 256)),   # rectangular blocks: nq != nkv
])
def test_packed_varlen_fwd_bwd_matches_oracle(causal, lens, blocks):
    B, S, Hq, Hkv, D = 3, 512, 4, 2, 64
    align = max(blocks)
    q, k, v, do = _make(B, S, Hq, Hkv, D, lens)
    (qp, kp, vp, dop), starts, T = pack_padded_batch(
        [q, k, v, do], lens, align=align)
    cu = list(starts) + [T]

    def packed_attn(qp, kp, vp):
        return flash_attn_varlen_func(
            qp, kp, vp, cu, seqlens=lens, causal=causal,
            block_q=blocks[0], block_kv=blocks[1])

    out_p, vjp = jax.vjp(packed_attn, qp, kp, vp)
    grads_p = vjp(dop)
    out = unpack_padded_batch(out_p, starts, lens, S)

    mask = jnp.arange(S)[None, :] < jnp.asarray(lens)[:, None]
    ref, vjp_ref = jax.vjp(
        lambda q, k, v: flash_attn_reference(
            q, k, v, query_padding_mask=mask, key_padding_mask=mask,
            causal=causal), q, k, v)
    grads_ref = vjp_ref(do)

    keep = mask[:, :, None, None]
    assert _err(out, ref * keep) < 2e-5
    for gp, gr, name in zip(grads_p, grads_ref, ("dq", "dk", "dv")):
        g = unpack_padded_batch(gp, starts, lens, S)
        assert _err(g, gr * keep) < 5e-5, (name, _err(g, gr * keep))
        # Padded positions of the PACKED stream carry exact zeros.
        live = np.zeros(gp.shape[1] if gp.ndim == 4 else gp.shape[0], bool)
        for s0, l in zip(starts, lens):
            live[int(s0):int(s0) + int(l)] = True
        dead = gp[:, ~live] if gp.ndim == 4 else gp[~live]
        assert float(jnp.max(jnp.abs(dead))) == 0.0, name


def test_packed_varlen_fwd_zero_fill_and_lse():
    """Dead packed rows: out == 0, lse == -inf; live rows' lse matches the
    dense kernel's base-2 LSE."""
    from fa2_jax import flash_attn_func

    lens = (300, 512)
    B, S, Hq, Hkv, D = 2, 512, 2, 2, 64
    q, k, v, _ = _make(B, S, Hq, Hkv, D, lens)
    (qp, kp, vp), starts, T = pack_padded_batch([q, k, v], lens, align=512)
    cu = list(starts) + [T]
    out_p, lse_p = flash_attn_varlen_func(
        qp, kp, vp, cu, seqlens=lens, causal=True, return_lse=True)
    mask = jnp.arange(S)[None, :] < jnp.asarray(lens)[:, None]
    _, lse_ref = flash_attn_func(q, k, v, attention_mask=mask, causal=True,
                                 return_lse=True)
    for b, (s0, l) in enumerate(zip(starts, lens)):
        seg = lse_p[0, :, int(s0):int(s0) + S]
        assert _err(seg[:, :l], lse_ref[b, :, :l]) < 1e-5
        if l < S:
            assert bool(jnp.all(seg[:, l:] == -jnp.inf))
            assert float(
                jnp.max(jnp.abs(out_p[0, int(s0) + l:int(s0) + S]))) == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_packed_varlen_dropout_matches_oracle(causal):
    """Packed dropout stream (global packed coordinates — see
    `ops/varlen._packed_dropout_bits`): fwd+bwd match the oracle fed the
    bit-identical keep-mask, rebuilt per segment in pure jnp."""
    from fa2_jax.utils.rng import (
        counter_hash_uint32, dropout_threshold,
    )

    lens = (300, 512)
    B, S, Hq, Hkv, D = 2, 512, 2, 2, 64
    p_drop, seed = 0.2, 1234
    q, k, v, do = _make(B, S, Hq, Hkv, D, lens)
    (qp, kp, vp, dop), starts, T = pack_padded_batch(
        [q, k, v, do], lens, align=512)
    cu = list(starts) + [T]

    out_p, vjp = jax.vjp(
        lambda qp, kp, vp: flash_attn_varlen_func(
            qp, kp, vp, cu, seqlens=lens, causal=causal,
            dropout_p=p_drop, dropout_seed=seed), qp, kp, vp)
    grads_p = vjp(dop)
    out = unpack_padded_batch(out_p, starts, lens, S)

    # Oracle keep-mask from the packed stream's counter formula.
    h = jnp.arange(Hq, dtype=jnp.uint32).reshape(-1, 1, 1)
    masks = []
    for s0 in starts:
        r = jnp.uint32(int(s0)) + jnp.arange(S, dtype=jnp.uint32).reshape(1, -1, 1)
        c = jnp.uint32(int(s0)) + jnp.arange(S, dtype=jnp.uint32).reshape(1, 1, -1)
        s_h = counter_hash_uint32(jnp.uint32(seed), h)
        bits = counter_hash_uint32(counter_hash_uint32(s_h, r), c)
        masks.append(bits >= jnp.uint32(dropout_threshold(p_drop)))
    keep_mask = jnp.stack(masks)  # [B, H, S, S]

    mask = jnp.arange(S)[None, :] < jnp.asarray(lens)[:, None]
    ref, vjp_ref = jax.vjp(
        lambda q, k, v: flash_attn_reference(
            q, k, v, query_padding_mask=mask, key_padding_mask=mask,
            causal=causal, dropout_p=p_drop, dropout_mask=keep_mask),
        q, k, v)
    grads_ref = vjp_ref(do)

    keep = mask[:, :, None, None]
    assert _err(out, ref * keep) < 5e-5
    for gp, gr, name in zip(grads_p, grads_ref, ("dq", "dk", "dv")):
        g = unpack_padded_batch(gp, starts, lens, S)
        assert _err(g, gr * keep) < 2e-4, (name, _err(g, gr * keep))

    # Determinism + seed sensitivity.
    out_p2 = flash_attn_varlen_func(
        qp, kp, vp, cu, seqlens=lens, causal=causal,
        dropout_p=p_drop, dropout_seed=seed)
    assert _err(out_p, out_p2) == 0.0
    out_p3 = flash_attn_varlen_func(
        qp, kp, vp, cu, seqlens=lens, causal=causal,
        dropout_p=p_drop, dropout_seed=seed + 1)
    assert _err(out_p, out_p3) > 1e-3
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        flash_attn_varlen_func(qp, kp, vp, cu, seqlens=lens,
                               dropout_p=p_drop)


def test_schedule_block_accounting():
    """The index lists contain exactly the needed blocks: at 50% real tokens
    the non-causal lists hold half the dense pair count, and causal lists
    enumerate the triangular count."""
    starts, T = [0, 2048], 4096
    exts = _seg_extents(starts, T)
    # 50% real tokens, non-causal: 2 live q blocks of 4 per segment, each
    # seeing 2 kv blocks; dead q blocks list nothing.
    meta, lists = _build_schedule(starts, exts, [1024, 1024], [1024, 1024],
                                  512, 512, causal=False)
    assert meta.shape[0] == 8 and lists.shape[1] == 2
    assert list(meta[:, 4]) == [2, 2, 0, 0, 2, 2, 0, 0]
    # Causal full: triangular per segment, from both sides.
    meta, lists = _build_schedule(starts, exts, [2048, 2048], [2048, 2048],
                                  512, 512, causal=True)
    assert int(meta[:, 4].sum()) == 2 * (1 + 2 + 3 + 4)
    assert list(lists[3]) == [0, 1, 2, 3]
    meta_kv, lists_kv = _build_schedule(
        starts, exts, [2048, 2048], [2048, 2048], 512, 512, causal=True,
        kv_major=True)
    assert list(meta_kv[:4, 4]) == [4, 3, 2, 1]
    assert list(lists_kv[5, :3]) == [5, 6, 7]
