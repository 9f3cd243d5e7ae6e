"""Ground the JAX oracle itself against an independent implementation
(torch CPU scaled_dot_product_attention), so the whole validation chain
doesn't float freely."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax import flash_attn_reference

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_oracle_vs_torch_sdpa(causal, gqa):
    B, Sq, Sk, Hq, D = 2, 64, 64, 4, 32
    Hkv = 2 if gqa else 4
    rng = np.random.RandomState(0)
    q = rng.normal(0, 0.5, (B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, Sk, Hkv, D)).astype(np.float32)

    out = np.asarray(flash_attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))

    tq = torch.from_numpy(q).permute(0, 2, 1, 3)
    tk = torch.from_numpy(k).permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    tv = torch.from_numpy(v).permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    ref = torch.nn.functional.scaled_dot_product_attention(
        tq, tk, tv, is_causal=causal, scale=1.0 / math.sqrt(D)
    ).permute(0, 2, 1, 3).numpy()

    assert np.max(np.abs(out - ref)) < 1e-5


def test_oracle_lse_analytic():
    """LSE from the oracle equals a direct dense computation, in base-2."""
    B, S, H, D = 1, 32, 2, 16
    rng = np.random.RandomState(1)
    q = jnp.asarray(rng.normal(0, 0.5, (B, S, H, D)), jnp.float32)
    k = jnp.asarray(rng.normal(0, 0.5, (B, S, H, D)), jnp.float32)
    v = jnp.asarray(rng.normal(0, 0.5, (B, S, H, D)), jnp.float32)
    _, lse = flash_attn_reference(q, k, v, return_lse=True)
    # precision: GPU fp32 einsums default to TF32 matmuls; the
    # max-subtraction matches the oracle's algorithm so the comparison only
    # measures the identity, not exp() argument-range sensitivity.
    scores = jnp.einsum("bthd,bshd->bhts", q / math.sqrt(D), k,
                        precision="highest")
    m = jnp.max(scores, axis=-1)
    lse_direct = (m + jnp.log(jnp.sum(jnp.exp(scores - m[..., None]), axis=-1))
                  ) * 1.4426950408889634
    assert float(jnp.max(jnp.abs(lse - lse_direct))) < 1e-4
