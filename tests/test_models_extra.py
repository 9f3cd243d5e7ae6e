"""Second model family (GPT-2 style) and Mistral-style sliding-window LLaMA:
training forward/grad and KV-cache decode consistency, plus oracle parity of
the windowed attention inside a real model."""
import jax
import jax.numpy as jnp
import pytest

from fa2_jax import flash_attn_reference
from fa2_jax.models import GPT2Config, LlamaConfig, gpt2
from fa2_jax.models.llama import (
    forward as llama_forward,
    init_params as llama_init,
    make_attention_fn,
)

GCFG = GPT2Config(
    vocab_size=256, dim=128, n_layers=2, n_heads=4, hidden_dim=256,
    max_seq_len=128, dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def gparams():
    return gpt2.init_params(jax.random.PRNGKey(0), GCFG)


def test_gpt2_forward_and_grad(gparams):
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0, GCFG.vocab_size)
    loss, grads = jax.value_and_grad(lambda p: gpt2.loss_fn(p, tokens, GCFG))(gparams)
    assert bool(jnp.isfinite(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in flat)


def test_gpt2_kv_cache_decode_matches_full(gparams):
    B, S_prefill, S_total = 2, 24, 28
    tokens = jax.random.randint(jax.random.PRNGKey(2), (B, S_total), 0, GCFG.vocab_size)
    full = gpt2.forward(gparams, tokens, GCFG)
    caches = gpt2.init_kv_cache(GCFG, B, 64)
    logits, caches = gpt2.forward_with_cache(
        gparams, tokens[:, :S_prefill], GCFG, caches, jnp.int32(0))
    err0 = float(jnp.max(jnp.abs(logits - full[:, :S_prefill])))
    assert err0 < 2e-3, err0
    for t in range(S_prefill, S_total):
        logits, caches = gpt2.forward_with_cache(
            gparams, tokens[:, t:t + 1], GCFG, caches, jnp.int32(t))
        err = float(jnp.max(jnp.abs(logits[:, 0] - full[:, t])))
        assert err < 2e-3, (t, err)


def test_llama_sliding_window_attention_matches_oracle():
    """The config-driven windowed attention must equal the oracle's
    sliding-window attention (reference `construct_local_mask` semantics)."""
    cfg = LlamaConfig(
        vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=64, dtype=jnp.float32, sliding_window=16,
    )
    attn = make_attention_fn(cfg)
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    q = jax.random.normal(ks[0], (2, 48, 4, 64), jnp.float32) * 0.5
    k = jax.random.normal(ks[1], (2, 48, 2, 64), jnp.float32) * 0.5
    v = jax.random.normal(ks[2], (2, 48, 2, 64), jnp.float32) * 0.5
    out = attn(q, k, v, None)
    ref = flash_attn_reference(q, k, v, causal=True, window_size=(16, 0))
    err = float(jnp.max(jnp.abs(out - ref)))
    assert err < 2e-5, err


def test_llama_sliding_window_forward_differs_from_full():
    cfg_w = LlamaConfig(
        vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=64, dtype=jnp.float32, sliding_window=8,
    )
    cfg_full = LlamaConfig(
        vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=64, dtype=jnp.float32,
    )
    params = llama_init(jax.random.PRNGKey(4), cfg_full)
    tokens = jax.random.randint(jax.random.PRNGKey(5), (1, 48), 0, 64)
    lw = llama_forward(params, tokens, cfg_w)
    lf = llama_forward(params, tokens, cfg_full)
    # Early positions (inside the window) agree; late positions must not.
    assert float(jnp.max(jnp.abs(lw[:, :8] - lf[:, :8]))) < 1e-4
    assert float(jnp.max(jnp.abs(lw[:, -1] - lf[:, -1]))) > 1e-4


def test_remat_matches_no_remat():
    """cfg.remat=True (per-layer rematerialization) must not change the loss
    or the gradients — only the memory/FLOPs trade."""
    import dataclasses

    import numpy as np

    from fa2_jax.models import LlamaConfig, init_params, loss_fn

    cfg = LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=96, max_seq_len=64,
                      dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0,
                                cfg.vocab_size)
    cfg_r = dataclasses.replace(cfg, remat=True)
    l0, g0 = jax.value_and_grad(lambda p: loss_fn(p, tokens, cfg))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss_fn(p, tokens, cfg_r))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
