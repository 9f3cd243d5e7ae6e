"""Tensor-parallel serving: a TP engine on the virtual CPU mesh must produce
the SAME greedy tokens as the single-device engine (BASELINE's 1 -> N host
scaling metric's correctness surface; the perf side is tokens/s on real
chips). Covers the dense cache, the paged cache, int8 KV quantization and
int8 weight-only quantization."""
import jax
import jax.numpy as jnp
import pytest

from fa2_jax.models.llama import (
    LlamaConfig, init_params, quantize_model_params,
)
from fa2_jax.parallel.mesh import make_mesh
from fa2_jax.runtime.serving import Engine

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2,
    reason="needs >= 2 devices (run on the virtual CPU mesh, tests/conftest.py)",
)

CFG = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  hidden_dim=128, max_seq_len=256, dtype=jnp.float32)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [20] * 40]


def _generate(params, mesh, **engine_kwargs):
    eng = Engine(params, CFG, n_slots=4, max_seq=256, mesh=mesh, **engine_kwargs)
    reqs = [eng.submit(p, 10) for p in PROMPTS]
    stats = eng.run()
    assert stats.decode_tokens > 0
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(model=2, devices=jax.devices()[:2])


def test_tp_engine_matches_single_device(params, mesh):
    assert _generate(params, None) == _generate(params, mesh)


def test_tp_engine_paged(params, mesh):
    assert (_generate(params, None, paged=True)
            == _generate(params, mesh, paged=True))


def test_tp_engine_int8_kv_cache(params, mesh):
    assert (_generate(params, None, qdtype=jnp.int8)
            == _generate(params, mesh, qdtype=jnp.int8))


def test_tp_engine_int8_weights(params, mesh):
    qp = quantize_model_params(params)
    assert _generate(qp, None) == _generate(qp, mesh)


def test_dp_tp_engine_matches_single_device(params):
    """(data=2, model=2) DataParallelEngine: two TP replicas fed from a
    shared queue produce the single-device engine's greedy tokens
    (VERDICT r2: serve across the data axis)."""
    from fa2_jax.runtime.serving import DataParallelEngine

    mesh4 = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    dp = DataParallelEngine(params, CFG, mesh4, n_slots=2, max_seq=256)
    reqs = [dp.submit(p, 10) for p in PROMPTS]
    stats = dp.run()
    assert stats.decode_tokens > 0
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == _generate(params, None)
    # Work actually spread over both replicas.
    assert all(e.stats.decode_tokens > 0 for e in dp.engines)


def test_tp_engine_prefix_cache(params, mesh):
    """The suffix-prefill path (page gather -> chunk prefill -> scatter) runs
    under shard_map with head-sharded pools; a repeated prompt must decode
    identical tokens to the cold TP engine AND hit the cache."""
    import numpy as np

    prompt = np.random.RandomState(9).randint(0, 256, size=150).tolist()

    def run(mesh_, prefix_cache):
        eng = Engine(params, CFG, n_slots=2, max_seq=256, mesh=mesh_,
                     paged=True, page_size=128, prefix_cache=prefix_cache)
        reqs = [eng.submit(prompt, 6), eng.submit(prompt, 6)]
        eng.run()
        return [r.out_tokens for r in reqs], eng.stats.prefix_cached_tokens

    cold, _ = run(None, False)
    warm_tp, hits = run(mesh, True)
    assert warm_tp == cold
    assert hits == 128
