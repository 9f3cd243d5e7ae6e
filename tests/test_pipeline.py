"""Pipeline parallelism (`parallel/pipeline.py`).

Contract: the GPipe schedule over the `pipe` mesh axis computes exactly the
sequential layer stack — forward logits AND gradients (reverse-mode AD
through the scan/ppermute schedule is the mirrored backward pipeline) — on
the virtual 8-device mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, forward, init_params, loss_fn
from fa2_jax.parallel import make_mesh
from fa2_jax.parallel.pipeline import (
    make_llama_pipeline_forward,
    make_pipeline,
    pipeline_params_from_llama,
    stack_layer_params,
)


def _cfg(n_layers=4):
    return LlamaConfig(
        vocab_size=128, dim=64, n_layers=n_layers, n_heads=4, n_kv_heads=2,
        hidden_dim=96, max_seq_len=64, dtype=jnp.float32,
    )


def test_generic_pipeline_matches_sequential():
    """A toy 8-layer MLP stack over 4 stages x 3 microbatches must equal the
    sequential application."""
    mesh = make_mesh(pipe=4)
    L, D, M, mb = 8, 16, 3, 4
    keys = jax.random.split(jax.random.PRNGKey(0), L)
    layers = [{"w": jax.random.normal(k, (D, D)) / jnp.sqrt(D)} for k in keys]
    stacked = stack_layer_params(layers)
    xs = jax.random.normal(jax.random.PRNGKey(1), (M, mb, D))

    def stage_fn(local, x):
        def body(x, layer):
            return jnp.tanh(x @ layer["w"]), None
        return jax.lax.scan(body, x, local)[0]

    with mesh:
        ys = jax.jit(make_pipeline(mesh, stage_fn, M))(stacked, xs)

    ref = xs
    for layer in layers:
        ref = jnp.tanh(ref @ layer["w"])
    np.testing.assert_allclose(np.asarray(ys), np.asarray(ref),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 3)])
def test_llama_pipeline_matches_single_device(n_stages, n_micro):
    cfg = _cfg(n_layers=4)
    params = init_params(jax.random.PRNGKey(0), cfg)
    B = 2 * n_micro if n_micro > 1 else 2
    B = n_micro * 2
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, 32), 0,
                                cfg.vocab_size)
    ref = forward(params, tokens, cfg)

    mesh = make_mesh(pipe=n_stages)
    pf = make_llama_pipeline_forward(mesh, cfg, n_microbatches=n_micro)
    pp = pipeline_params_from_llama(params, mesh)
    with mesh:
        out = jax.jit(pf)(pp, tokens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)


def test_pipeline_gradients_match_sequential():
    """Grad of the microbatched pipeline loss == grad of the plain loss."""
    cfg = _cfg(n_layers=4)
    params = init_params(jax.random.PRNGKey(2), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 24), 0,
                                cfg.vocab_size)
    mesh = make_mesh(pipe=2)
    pf = make_llama_pipeline_forward(mesh, cfg, n_microbatches=2)

    def pipe_loss(params):
        pp = pipeline_params_from_llama(params)
        logits = pf(pp, tokens[:, :-1])
        targets = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(
            jnp.take_along_axis(logp, targets[..., None], axis=-1))

    ref_loss, ref_g = jax.value_and_grad(
        lambda p: loss_fn(p, tokens, cfg))(params)
    with mesh:
        pl, pg = jax.jit(jax.value_and_grad(pipe_loss))(params)
    np.testing.assert_allclose(float(pl), float(ref_loss), rtol=1e-5)
    flat_ref = jax.tree_util.tree_leaves(ref_g)
    flat_pipe = jax.tree_util.tree_leaves(pg)
    for a, b in zip(flat_ref, flat_pipe):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-4, rtol=1e-3)


def test_llama_3d_pp_dp_tp_matches_single_device():
    """Composed pp=2 x dp=2 x tp=2 (all 8 virtual devices) forward must
    match the plain single-device model, and grads must flow."""
    cfg = _cfg(n_layers=4)
    params = init_params(jax.random.PRNGKey(4), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(5), (8, 32), 0,
                                cfg.vocab_size)
    ref = forward(params, tokens, cfg)

    from fa2_jax.parallel.pipeline import make_llama_3d_forward

    mesh = make_mesh(pipe=2, data=2, model=2)
    f3d = make_llama_3d_forward(mesh, cfg, n_microbatches=2)
    pp = pipeline_params_from_llama(params, mesh, tp=True)
    with mesh:
        out = jax.jit(f3d)(pp, tokens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)

    def loss(pp):
        logits = f3d(pp, tokens)
        return jnp.mean(jax.nn.log_softmax(logits) ** 2)

    with mesh:
        g = jax.jit(jax.grad(loss))(pp)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)
    assert any(bool(jnp.any(l != 0)) for l in leaves)
