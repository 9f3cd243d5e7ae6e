"""Forward+backward numerics grid (reference `tests/test_fwd_bwd.py`).

The default grid is a curated sweep of the reference's adversarial axes
(prime seqlens, seqlen_q <> seqlen_k causal, odd head dims, GQA/MQA,
mask/bias); set FA2_FULL_GRID=1 for the reference-scale grid (slow on CPU
interpret mode, intended for GPU runs).
"""
import os

import jax
import jax.numpy as jnp
import pytest

from tests.core import run_attention_case

FULL = bool(int(os.environ.get("FA2_FULL_GRID", "0")))

# (seqlen_q, seqlen_k) pairs: aligned, prime, asymmetric both ways.
SEQLEN_PAIRS = [
    (128, 128),
    (113, 255),
    (255, 113),
    (1, 239),
] + ([(256, 256), (239, 1), (384, 37), (37, 384), (512, 512), (1024, 1024)] if FULL else [])

HEAD_DIMS = [32, 40, 64, 111, 128] + ([207, 256] if FULL else [])
HEADS = [(8, 2), (9, 9)] + ([(8, 1)] if FULL else [])
DTYPES = ([jnp.float32, jnp.float16] if FULL else [])


# fp16 parity: the reference's whole grid runs fp16 (`tests/test_fwd_bwd.py:13`
# there); bf16 is the training default but fp16 I/O must work and stay pinned.
@pytest.mark.parametrize("causal", [False, True])
def test_fp16(causal):
    run_attention_case(2, 4, 2, 255, 255, 64, causal=causal, dtype=jnp.float16)


def test_fp16_mask_gqa():
    run_attention_case(2, 8, 2, 128, 128, 128, causal=True,
                       use_attention_mask=True, dtype=jnp.float16)


def test_fp16_bf16_compute_opt_in():
    """fp16 I/O with fp16_compute_dtype=bfloat16 (the full-tensor-core-rate option,
    VERDICT r2): output stays within the FA relative-tolerance contract of
    a low-precision oracle — bf16's mantissa error profile matches fp16's."""
    from fa2_jax import flash_attn_func, flash_attn_reference

    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    q = (jax.random.normal(ks[0], (2, 255, 4, 64)) * 0.5).astype(jnp.float16)
    k = (jax.random.normal(ks[1], (2, 255, 2, 64)) * 0.5).astype(jnp.float16)
    v = (jax.random.normal(ks[2], (2, 255, 2, 64)) * 0.5).astype(jnp.float16)
    out = flash_attn_func(q, k, v, causal=True,
                          fp16_compute_dtype=jnp.bfloat16)
    assert out.dtype == jnp.float16
    ref = flash_attn_reference(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        causal=True)
    # The right error yardstick is a bf16 low-precision oracle (that IS the
    # compute dtype the user opted into).
    refb = flash_attn_reference(
        q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
        v.astype(jnp.bfloat16), causal=True, upcast=False, reorder_ops=True)
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref))
    err_pt = jnp.max(jnp.abs(refb.astype(jnp.float32) - ref))
    assert float(err) <= 2 * float(err_pt) + 1e-4, (float(err), float(err_pt))


@pytest.mark.parametrize("seqlen_q,seqlen_k", SEQLEN_PAIRS)
@pytest.mark.parametrize("causal", [False, True])
def test_seqlens(seqlen_q, seqlen_k, causal):
    run_attention_case(2, 4, 2, seqlen_q, seqlen_k, 64, causal=causal)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_head_dims(head_dim):
    run_attention_case(2, 4, 2, 255, 255, head_dim, causal=True)


@pytest.mark.parametrize("nheads_q,nheads_kv", HEADS)
@pytest.mark.parametrize("causal", [True] + ([False] if FULL else []))
def test_gqa(nheads_q, nheads_kv, causal):
    run_attention_case(2, nheads_q, nheads_kv, 128, 128, 64, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask,use_bias", [(True, False), (False, True)])
def test_mask_bias(causal, use_mask, use_bias):
    run_attention_case(
        2, 4, 2, 255, 255, 64, causal=causal,
        use_attention_mask=use_mask, use_bias=use_bias,
    )


# bf16 is the dtype of every other case in this file; an fp32 sweep only
# runs in the FULL grid.
if FULL:

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_dtypes(dtype):
        run_attention_case(2, 4, 2, 256, 256, 128, causal=True, dtype=dtype)


if FULL:

    @pytest.mark.parametrize("seqlen_q,seqlen_k", SEQLEN_PAIRS)
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("head_dim", HEAD_DIMS)
    @pytest.mark.parametrize("use_mask,use_bias", [(False, False), (True, False), (False, True)])
    def test_full_grid(seqlen_q, seqlen_k, causal, head_dim, use_mask, use_bias):
        if use_mask and seqlen_q != seqlen_k:
            pytest.skip("mask requires seqlen_q == seqlen_k")
        run_attention_case(
            4, 8, 2, seqlen_q, seqlen_k, head_dim, causal=causal,
            use_attention_mask=use_mask, use_bias=use_bias,
        )

    # Adversarial-shape sweep of the feature axes the curated grid covers
    # only at fixed shapes: sliding window, softcap, bwd dropout, and the
    # bias x mask combination the reference FORBIDS
    # (`/root/reference/src/forward/caller.py:27`) but this framework allows.
    @pytest.mark.parametrize("seqlen_q,seqlen_k", SEQLEN_PAIRS)
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize(
        "window,softcap,dropout_p",
        [((37, -1), 0.0, 0.0), ((64, 11), 0.0, 0.0), ((-1, -1), 30.0, 0.0),
         ((-1, -1), 0.0, 0.17), ((128, 0), 15.0, 0.0)],
    )
    def test_full_grid_features(seqlen_q, seqlen_k, causal, window,
                                softcap, dropout_p):
        # Dropout x single-key/query shapes break the RELATIVE tolerance
        # model: with seqlen_k == 1, p == 1 structurally, so both oracle
        # variants coincide EXACTLY (pt yardstick error is 0) and the
        # comparison degenerates to the tiny absolute bias, which ordinary
        # accumulation-order noise (~1e-5 on 239-row dV sums) exceeds. No
        # kernel arrangement can win a 0-yardstick; the dropout bwd path on
        # these shapes is covered without dropout, and dropout is covered on
        # non-degenerate shapes.
        if dropout_p > 0 and (seqlen_q == 1 or seqlen_k == 1):
            pytest.skip("relative-tolerance yardstick degenerates to 0")
        dtype = jnp.float32 if dropout_p > 0 else jnp.bfloat16
        run_attention_case(
            2, 4, 2, seqlen_q, seqlen_k, 64, causal=causal,
            window_size=window, softcap=softcap, dropout_p=dropout_p,
            dtype=dtype,
        )

    @pytest.mark.parametrize("seqlen", [128, 255, 384])
    @pytest.mark.parametrize("causal", [False, True])
    def test_full_grid_bias_and_mask(seqlen, causal):
        run_attention_case(
            2, 4, 2, seqlen, seqlen, 64, causal=causal,
            use_attention_mask=True, use_bias=True,
        )
