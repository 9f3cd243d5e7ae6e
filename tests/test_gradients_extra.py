"""Gradient paths the reference silently drops: trainable-bias gradients
(dbias — reference `src/wrapper.py:86` returns None), the logsumexp
cotangent (reference LSE is test-only), and the dropout seed API contract
(reference draws a fresh seed per call, `src/utils.py:86`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax import flash_attn_func, flash_attn_reference
from tests.utils import GRAD_ERROR_BIAS, GRAD_ERROR_MUL, generate_test_data, max_diff


def _dbias_case(bias_shape, causal=True, softcap=0.0, dtype=jnp.bfloat16,
                seqlen_q=128, seqlen_k=128):
    B, Hq, Hkv, D = 2, 4, 2, 64
    q, k, v, do = generate_test_data(B, Hq, Hkv, seqlen_q, seqlen_k, D, dtype)
    rng = np.random.RandomState(7)
    bias = jnp.asarray(rng.normal(0, 0.5, bias_shape), dtype)

    def ours(b):
        return flash_attn_func(q, k, v, attention_bias=b, causal=causal,
                               softcap=softcap)

    def ref(b, upcast, reorder):
        return flash_attn_reference(q, k, v, attn_bias=b, causal=causal,
                                    softcap=softcap, upcast=upcast,
                                    reorder_ops=reorder)

    _, vjp_ours = jax.vjp(ours, bias)
    _, vjp_ref = jax.vjp(lambda b: ref(b, True, False), bias)
    _, vjp_pt = jax.vjp(lambda b: ref(b, False, True), bias)
    (db,), (db_ref,), (db_pt,) = vjp_ours(do), vjp_ref(do), vjp_pt(do)
    assert db.shape == bias.shape and db.dtype == bias.dtype
    err, pt_err = max_diff(db, db_ref), max_diff(db_pt, db_ref)
    assert err <= GRAD_ERROR_MUL * pt_err + GRAD_ERROR_BIAS, (
        f"dbias: {err:.3e} > {GRAD_ERROR_MUL} * {pt_err:.3e} + {GRAD_ERROR_BIAS}"
    )


@pytest.mark.parametrize("bias_bh", [(2, 4), (1, 1), (2, 1), (1, 4)])
def test_dbias_broadcast_shapes(bias_bh):
    Bb, Hb = bias_bh
    _dbias_case((Bb, Hb, 128, 128))


@pytest.mark.parametrize("causal", [False, True])
def test_dbias_unaligned_seqlens(causal):
    _dbias_case((1, 4, 113, 255), causal=causal, seqlen_q=113, seqlen_k=255)


def test_dbias_softcap():
    _dbias_case((1, 4, 128, 128), softcap=5.0, dtype=jnp.float32)


def _valid_lse_loss(lse, mask):
    return jnp.sum(jnp.where(mask, jnp.sin(lse), 0.0))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout_p", [0.0, 0.17])
def test_lse_cotangent(causal, dropout_p):
    """Differentiating a loss that consumes the LSE output must propagate the
    LSE cotangent (folded into delta), not silently drop it."""
    from fa2_jax.utils.rng import dropout_keep_mask_reference

    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 128, 128, 64
    q, k, v, _ = generate_test_data(B, Hq, Hkv, Sq, Sk, D, jnp.float32)
    seed = 11
    dmask = (dropout_keep_mask_reference(seed, dropout_p, B, Hq, Sq, Sk)
             if dropout_p > 0 else None)

    def f_ours(q, k, v):
        o, lse = flash_attn_func(q, k, v, causal=causal, dropout_p=dropout_p,
                                 dropout_seed=seed, return_lse=True)
        return jnp.sum(o * o) + _valid_lse_loss(lse, jnp.isfinite(lse))

    def f_ref(q, k, v):
        o, lse = flash_attn_reference(q, k, v, causal=causal,
                                      dropout_p=dropout_p, dropout_mask=dmask,
                                      return_lse=True)
        return jnp.sum(o * o) + _valid_lse_loss(lse, jnp.isfinite(lse))

    g_ours = jax.grad(f_ours, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip(("dq", "dk", "dv"), g_ours, g_ref):
        err = max_diff(a, b)
        # 2e-4 absolute on O(10) gradients: fp32 reduction-order noise; the
        # compiled kernels can land near ~1e-4 where CPU interpret gives ~3e-6.
        assert err < 2e-4, f"{name} lse-cotangent err {err:.3e}"


def test_lse_cotangent_varlen():
    """Varlen: LSE gradients flow only through valid rows (the kernel emits
    -inf beyond each batch's true length; the oracle pads differently, so
    the loss is restricted to the shared valid region)."""
    B, Hq, Hkv, S, D = 2, 4, 2, 128, 64
    q, k, v, _ = generate_test_data(B, Hq, Hkv, S, S, D, jnp.float32)
    lens = np.array([100, S])
    amask = jnp.asarray(np.arange(S)[None, :] < lens[:, None])
    valid = amask[:, None, :]  # [B, 1, S] -> broadcast over heads

    def f_ours(q):
        o, lse = flash_attn_func(q, k, v, attention_mask=amask, causal=True,
                                 return_lse=True)
        return jnp.sum(o * o) + _valid_lse_loss(lse, valid)

    def f_ref(q):
        o, lse = flash_attn_reference(
            q, k, v, query_padding_mask=amask, key_padding_mask=amask,
            causal=True, return_lse=True)
        return jnp.sum(o * o) + _valid_lse_loss(lse, valid)

    err = max_diff(jax.grad(f_ours)(q), jax.grad(f_ref)(q))
    assert err < 5e-5, f"varlen lse-cotangent err {err:.3e}"


def test_dropout_requires_seed():
    q, k, v, _ = generate_test_data(1, 2, 2, 128, 128, 64, jnp.float32)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        flash_attn_func(q, k, v, dropout_p=0.1)


def test_dropout_rng_key_derivation():
    """Distinct rng keys give distinct masks; the same key is deterministic."""
    q, k, v, _ = generate_test_data(1, 2, 2, 128, 128, 64, jnp.float32)
    o1 = flash_attn_func(q, k, v, dropout_p=0.3, dropout_rng=jax.random.PRNGKey(0))
    o2 = flash_attn_func(q, k, v, dropout_p=0.3, dropout_rng=jax.random.PRNGKey(1))
    o1b = flash_attn_func(q, k, v, dropout_p=0.3, dropout_rng=jax.random.PRNGKey(0))
    assert bool(jnp.any(o1 != o2)), "different keys reused the same mask"
    assert bool(jnp.all(o1 == o1b)), "same key not deterministic"
