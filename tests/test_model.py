"""End-to-end model slice: tiny LLaMA on the flash kernels — forward, loss,
a train step, and KV-cache decode consistency with the full forward."""
import jax
import jax.numpy as jnp
import optax
import pytest

from fa2_jax.models import (
    LlamaConfig, forward, forward_with_cache, init_kv_cache, init_params, loss_fn,
)

CFG = LlamaConfig(
    vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=256, max_seq_len=128, dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def test_forward_shapes_finite(params):
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, CFG.vocab_size)
    logits = forward(params, tokens, CFG)
    assert logits.shape == (2, 64, CFG.vocab_size)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_train_step_reduces_loss(params):
    tokens = jax.random.randint(jax.random.PRNGKey(2), (4, 65), 0, CFG.vocab_size)
    opt = optax.adam(1e-3)
    state = opt.init(params)
    l0 = None

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, tokens, CFG))(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    p = params
    for i in range(8):
        p, state, loss = step(p, state)
        if l0 is None:
            l0 = float(loss)
    assert float(loss) < l0, (float(loss), l0)


def test_kv_cache_decode_matches_full_forward(params):
    """Prefill + single-token decode steps must match the full causal
    forward on the same sequence (the KV-cache path exercises the kernels'
    global position offsets)."""
    from fa2_jax.ops.attention import flash_attn_with_kv_cache

    B, S_prefill, S_total = 2, 48, 52
    tokens = jax.random.randint(jax.random.PRNGKey(3), (B, S_total), 0, CFG.vocab_size)

    full_logits = forward(params, tokens, CFG)

    caches = init_kv_cache(CFG, B, 128)

    def cached_attn(q, ck, cv, kv_len):
        return flash_attn_with_kv_cache(q, ck, cv, kv_len)

    logits, caches = forward_with_cache(
        params, tokens[:, :S_prefill], CFG, caches, jnp.int32(0), cached_attn
    )
    err0 = float(jnp.max(jnp.abs(logits - full_logits[:, :S_prefill])))
    assert err0 < 2e-3, err0

    for t in range(S_prefill, S_total):
        logits, caches = forward_with_cache(
            params, tokens[:, t:t + 1], CFG, caches, jnp.int32(t), cached_attn
        )
        err = float(jnp.max(jnp.abs(logits[:, 0] - full_logits[:, t])))
        assert err < 2e-3, (t, err)
