"""LoRA adapters (`models/lora.py`).

Contracts: zero-init B makes the merged model identical to the base; only
adapter leaves receive gradients (base frozen by construction); a few
adapter-only steps reduce the loss; the merged pytree serves through the
Engine unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax.models import LlamaConfig, forward, init_params, loss_fn
from fa2_jax.models.lora import init_lora, lora_loss_fn, merge_lora

CFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=96, max_seq_len=64, dtype=jnp.float32,
)


def test_zero_init_is_identity():
    params = init_params(jax.random.PRNGKey(0), CFG)
    lora = init_lora(jax.random.PRNGKey(1), params, rank=4)
    merged = merge_lora(params, lora)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0,
                                CFG.vocab_size)
    np.testing.assert_allclose(
        np.asarray(forward(merged, tokens, CFG)),
        np.asarray(forward(params, tokens, CFG)), atol=1e-6, rtol=1e-6)


def test_adapter_training_reduces_loss_base_frozen():
    params = init_params(jax.random.PRNGKey(0), CFG)
    lora = init_lora(jax.random.PRNGKey(1), params, rank=4)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (2, 33), 0,
                                CFG.vocab_size)

    grad_fn = jax.jit(jax.value_and_grad(
        lambda lo: lora_loss_fn(params, lo, tokens, CFG, loss_fn)))
    l0, g = grad_fn(lora)
    # B starts at zero but gets nonzero grads through A.
    gleaves = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in gleaves)
    assert any(bool(jnp.any(x != 0)) for x in gleaves)
    for _ in range(5):
        _, g = grad_fn(lora)
        lora = jax.tree.map(lambda p, gg: p - 0.1 * gg, lora, g)
    l1, _ = grad_fn(lora)
    assert float(l1) < float(l0), (float(l0), float(l1))
    # Only wq/wk/wv/wo have adapters; mlp weights untouched by merge.
    merged = merge_lora(params, lora)
    np.testing.assert_array_equal(
        np.asarray(merged["layers"][0]["w_gate"]),
        np.asarray(params["layers"][0]["w_gate"]))
    assert not np.allclose(np.asarray(merged["layers"][0]["wq"]),
                           np.asarray(params["layers"][0]["wq"]))


def test_merged_adapter_serves_through_engine():
    from fa2_jax.runtime import Engine

    params = init_params(jax.random.PRNGKey(0), CFG)
    lora = init_lora(jax.random.PRNGKey(1), params, rank=4)
    # Perturb B so the adapter actually changes the model.
    lora = jax.tree.map(
        lambda x: x + 0.01 if x.shape[0] == 4 else x, lora)
    merged = merge_lora(params, lora)
    prompt = [5, 6, 7, 8]
    toks = list(prompt)
    for _ in range(3):
        logits = forward(merged, jnp.asarray([toks], jnp.int32), CFG)
        toks.append(int(jnp.argmax(logits[0, -1])))
    ref = toks[len(prompt):]
    eng = Engine(merged, CFG, n_slots=2, max_seq=128)
    req = eng.submit(prompt, max_new_tokens=3)
    eng.run()
    assert req.out_tokens == ref, (req.out_tokens, ref)
