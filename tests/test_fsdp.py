"""FSDP / ZeRO-3 parameter sharding (`parallel/mesh.py:fsdp_param_pspecs`).

Contract: a jitted train step over fsdp-sharded params + optimizer state
produces the replicated step's loss and updated params (the partitioner
inserts the all-gather/reduce-scatter schedule from the annotations alone),
and the updated state actually COMES BACK sharded (1/dp of the bytes per
device for every large leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from fa2_jax.models import LlamaConfig, init_params, loss_fn
from fa2_jax.parallel import make_mesh
from fa2_jax.parallel.mesh import AXIS_DATA, fsdp_param_pspecs

CFG = LlamaConfig(
    vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=256, max_seq_len=64, dtype=jnp.float32,
)


def _step(params, opt_state, tokens, opt):
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(p, tokens, CFG))(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


def test_fsdp_train_step_matches_replicated():
    params = init_params(jax.random.PRNGKey(0), CFG)
    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 33), 0,
                                CFG.vocab_size)

    ref_params, _, ref_loss = jax.jit(
        lambda p, o, t: _step(p, o, t, opt))(params, opt_state, tokens)

    mesh = make_mesh(data=4)
    specs = fsdp_param_pspecs(params, mesh)
    # Large 2-D weights must be sharded, norms replicated.
    assert specs["layers"][0]["wq"] != P()
    assert specs["layers"][0]["attn_norm"] == P()

    shard = lambda t, sp: jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, sp)
    params_f = shard(params, specs)
    # Optimizer state shards along with its matching param leaves (ZeRO):
    # adam moments are param-shaped, scalars replicate.
    opt_state_f = opt.init(params_f)
    tokens_f = jax.device_put(
        tokens, NamedSharding(mesh, P(AXIS_DATA, None)))

    with jax.set_mesh(mesh):
        new_params, new_opt, loss = jax.jit(
            lambda p, o, t: _step(p, o, t, opt))(params_f, opt_state_f,
                                                 tokens_f)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(ref_params),
                    jax.tree_util.tree_leaves(new_params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=2e-5, rtol=1e-4)
    # The updated params keep the FSDP sharding (1/dp bytes per device).
    wq = new_params["layers"][0]["wq"]
    assert isinstance(wq.sharding, NamedSharding)
    assert AXIS_DATA in jax.tree_util.tree_leaves(
        [list(wq.sharding.spec)]), wq.sharding


def test_fsdp_composes_with_tp():
    """On a data x model mesh, fsdp_param_pspecs keeps the Megatron TP
    sharding AND shards a free dim over data (ZeRO-3 over the TP shards),
    and the composed train step matches the replicated step."""
    from fa2_jax.parallel.mesh import AXIS_MODEL, shard_params

    params = init_params(jax.random.PRNGKey(0), CFG)
    mesh = make_mesh(data=2, model=2)
    specs = fsdp_param_pspecs(params, mesh)
    l0 = specs["layers"][0]
    assert l0["wq"] == P(AXIS_DATA, AXIS_MODEL), l0["wq"]
    assert l0["wo"] == P(AXIS_MODEL, AXIS_DATA), l0["wo"]
    assert l0["w_down"] == P(AXIS_MODEL, AXIS_DATA), l0["w_down"]
    assert specs["embed"] == P(AXIS_DATA, None)
    assert specs["layers"][0]["attn_norm"] == P()  # small leaves replicated

    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (8, 33), 0,
                                CFG.vocab_size)
    ref_params, _, ref_loss = jax.jit(
        lambda p, o, t: _step(p, o, t, opt))(params, opt_state, tokens)

    sparams = shard_params(params, mesh, specs=specs)
    sopt = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), opt_state)
    stoks = jax.device_put(tokens, NamedSharding(mesh, P(AXIS_DATA, None)))
    new_params, _, loss = jax.jit(
        lambda p, o, t: _step(p, o, t, opt))(sparams, sopt, stoks)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_params["layers"][0]["wq"]),
        np.asarray(ref_params["layers"][0]["wq"]), atol=2e-5, rtol=1e-4)
