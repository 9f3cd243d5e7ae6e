"""LSE parity: kernel logsumexp vs analytic oracle LSE, in base-2 units.

The reference's LSE test is disabled/broken (`tests/test_logsumexp.py:26`
raises NotImplementedError); this is the working version: the kernel's stored
LSE must equal the natural-log LSE times log2(e) (SURVEY.md §2.2).
"""
import jax.numpy as jnp
import pytest

from fa2_jax import flash_attn_func, flash_attn_reference
from tests.utils import generate_attention_mask, generate_test_data


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seqlen_q,seqlen_k", [(128, 128), (113, 255), (255, 113)])
def test_lse_parity(causal, seqlen_q, seqlen_k):
    q, k, v, _ = generate_test_data(2, 4, 2, seqlen_q, seqlen_k, 64, jnp.float32)
    _, lse_ref = flash_attn_reference(q, k, v, causal=causal, return_lse=True)
    _, lse = flash_attn_func(q, k, v, causal=causal, return_lse=True)
    both_inf = jnp.isinf(lse_ref) & jnp.isinf(lse)
    err = jnp.max(jnp.abs(jnp.where(both_inf, 0.0, lse - lse_ref)))
    assert float(err) < 1e-4, float(err)


def test_lse_masked_rows():
    """Fully-masked rows (causal, seqlen_q > seqlen_k) carry lse = -inf and
    zero output."""
    q, k, v, _ = generate_test_data(1, 2, 2, 64, 16, 32, jnp.float32)
    out, lse = flash_attn_func(q, k, v, causal=True, return_lse=True)
    # Bottom-right aligned: rows 0..(64-16-1) see no keys at all.
    n_dead = 64 - 16
    assert bool(jnp.all(jnp.isinf(lse[:, :, :n_dead]) & (lse[:, :, :n_dead] < 0)))
    assert float(jnp.max(jnp.abs(out[:, :n_dead]))) == 0.0
    assert bool(jnp.all(jnp.isfinite(lse[:, :, n_dead:])))


def test_lse_with_padding_mask():
    q, k, v, _ = generate_test_data(3, 4, 2, 128, 128, 64, jnp.float32)
    mask = generate_attention_mask(3, 128)
    _, lse_ref = flash_attn_reference(
        q, k, v, query_padding_mask=mask, key_padding_mask=mask, return_lse=True
    )
    _, lse = flash_attn_func(q, k, v, attention_mask=mask, return_lse=True)
    valid = mask[:, None, :]
    err = jnp.max(jnp.abs(jnp.where(valid, lse - lse_ref, 0.0)))
    assert float(err) < 1e-4, float(err)
