"""Ulysses sequence parallelism (`parallel/ulysses.py`): exact parity with
the single-device kernel (fwd + grads, causal, GQA) on the virtual mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.ops.attention import flash_attn_func
from fa2_jax.parallel import make_mesh
from fa2_jax.parallel.ulysses import make_ulysses_attention


def _data(B=2, S=256, Hq=8, Hkv=4, D=64, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, S, Hq, D), jnp.float32) * 0.5
    k = jax.random.normal(ks[1], (B, S, Hkv, D), jnp.float32) * 0.5
    v = jax.random.normal(ks[2], (B, S, Hkv, D), jnp.float32) * 0.5
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_single_device(causal):
    q, k, v = _data()
    mesh = make_mesh(data=2, seq=4)
    attn = make_ulysses_attention(mesh, causal=causal)
    ref = flash_attn_func(q, k, v, causal=causal)
    with mesh:
        out = jax.jit(attn)(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_ulysses_grads_match():
    q, k, v = _data(S=128)
    mesh = make_mesh(seq=4)
    attn = make_ulysses_attention(mesh, causal=True)

    def loss(f):
        return lambda q, k, v: jnp.sum(f(q, k, v) ** 2)

    ref_g = jax.grad(loss(lambda q, k, v: flash_attn_func(q, k, v, causal=True)),
                     argnums=(0, 1, 2))(q, k, v)
    with mesh:
        got_g = jax.jit(jax.grad(loss(attn), argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(ref_g, got_g):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-5, rtol=5e-5)


def test_ulysses_window_softcap():
    q, k, v = _data(S=128, seed=3)
    mesh = make_mesh(seq=4)
    attn = make_ulysses_attention(mesh, causal=True, window_size=(32, 0),
                                  softcap=10.0)
    ref = flash_attn_func(q, k, v, causal=True, window_size=(32, 0),
                          softcap=10.0)
    with mesh:
        out = jax.jit(attn)(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
