"""Tests for the flax linen integration layer (`fa2_jax/layers.py`).

The reference has no module layer (users call `flash_attn_func` directly,
`/root/reference/src/wrapper.py:89-100`); this checks the linen wrapper's
plumbing: oracle parity of the attention core, GQA head layout, flax dropout
RNG feeding the kernel seed contract, and gradient flow through the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("flax")  # an optional dependency of the linen layer

from fa2_jax.layers import FlashSelfAttention  # noqa: E402
from fa2_jax.ops.reference import flash_attn_reference  # noqa: E402


def _make(B=2, S=64, F=128, **kw):
    layer = FlashSelfAttention(num_heads=4, **kw)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, S, F), jnp.float32) * 0.5
    params = layer.init(jax.random.PRNGKey(1), x)
    return layer, params, x


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_kv", [None, 2])
def test_linen_matches_oracle(causal, n_kv):
    """The module's attention core must equal the oracle applied to the same
    projected q/k/v (projections checked by re-deriving them from params)."""
    layer, params, x = _make(causal=causal, num_kv_heads=n_kv)
    out = layer.apply(params, x)
    assert out.shape == x.shape and jnp.all(jnp.isfinite(out))

    # Re-derive q/k/v with the module's own kernels and compare the
    # attention core against the oracle.
    p = params["params"]
    hd = p["q_proj"]["kernel"].shape[-1]
    q = jnp.einsum("bsf,fhd->bshd", x, p["q_proj"]["kernel"])
    k = jnp.einsum("bsf,fhd->bshd", x, p["k_proj"]["kernel"])
    v = jnp.einsum("bsf,fhd->bshd", x, p["v_proj"]["kernel"])
    ref = flash_attn_reference(q, k, v, causal=causal)
    ref = ref.reshape(*x.shape[:2], layer.num_heads * hd)
    ref = jnp.einsum("bsg,gf->bsf", ref, p["o_proj"]["kernel"])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-2, rtol=2e-2)


def test_linen_padding_mask():
    layer, params, x = _make()
    lens = jnp.array([40, 64])
    mask = jnp.arange(x.shape[1])[None, :] < lens[:, None]
    out = layer.apply(params, x, mask)
    assert jnp.all(jnp.isfinite(out))
    # Masked-out key positions must not influence valid rows: perturb padding.
    x2 = x.at[0, 50:].set(7.0)
    out2 = layer.apply(params, x2, mask)
    np.testing.assert_allclose(np.asarray(out[0, :40]), np.asarray(out2[0, :40]),
                               atol=1e-5, rtol=1e-5)


def test_linen_dropout_rng_contract():
    layer, params, x = _make(dropout_p=0.5)
    # deterministic=True: no rng needed, dropout off.
    out_det = layer.apply(params, x, deterministic=True)
    out_det2 = layer.apply(params, x, deterministic=True)
    np.testing.assert_array_equal(np.asarray(out_det), np.asarray(out_det2))

    # deterministic=False: needs the "dropout" rng; same rng => same output,
    # different rng => different output.
    a = layer.apply(params, x, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(3)})
    a2 = layer.apply(params, x, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(3)})
    b = layer.apply(params, x, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(4)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    assert not np.allclose(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(a), np.asarray(out_det))

    # Missing rng with dropout active must raise (kernel seed contract).
    with pytest.raises(Exception):
        layer.apply(params, x, deterministic=False)


def test_linen_rope_and_grads():
    layer, params, x = _make(causal=True, use_rope=True)

    def loss(p):
        return jnp.sum(layer.apply(p, x) ** 2)

    g = jax.grad(loss)(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(jnp.all(jnp.isfinite(l)) for l in leaves)
    assert any(jnp.any(l != 0) for l in leaves)
