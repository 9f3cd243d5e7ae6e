"""On-device sampling (`runtime/sampling.py`) and its serving integration.

Contracts: temperature 0 == argmax; top_k=1 is greedy under any temperature;
(seed, step) streams are deterministic and step-dependent; top-p/top-k
restrict support to the nucleus; the Engine reproduces a sampled request
bitwise across fresh engines and mixes greedy + sampled slots in one batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, forward, init_params
from fa2_jax.runtime import Engine, SamplingParams
from fa2_jax.runtime.sampling import sample_tokens

CFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=128, max_seq_len=256, dtype=jnp.float32,
)


def _call(logits, temp=0.0, top_k=0, top_p=1.0, seed=0, step=0):
    B = logits.shape[0]
    return sample_tokens(
        logits,
        jnp.full((B,), temp, jnp.float32),
        jnp.full((B,), top_k, jnp.int32),
        jnp.full((B,), top_p, jnp.float32),
        jnp.full((B,), seed, jnp.uint32),
        jnp.full((B,), step, jnp.int32),
    )


@pytest.fixture(scope="module")
def logits():
    return jax.random.normal(jax.random.PRNGKey(0), (4, 64)) * 3.0


def test_temperature_zero_is_argmax(logits):
    out = _call(logits, temp=0.0, seed=123, step=9)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(jnp.argmax(logits, axis=-1)))


def test_top_k_one_is_greedy_at_any_temperature(logits):
    for seed in (0, 7, 99):
        out = _call(logits, temp=5.0, top_k=1, seed=seed)
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray(jnp.argmax(logits, axis=-1)))


def test_seed_step_stream_deterministic(logits):
    a = _call(logits, temp=1.0, seed=5, step=3)
    b = _call(logits, temp=1.0, seed=5, step=3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Across steps the stream must actually vary (statistically certain
    # with 4 rows x 16 steps over 64 near-uniform logits).
    draws = [np.asarray(_call(logits, temp=10.0, seed=5, step=t))
             for t in range(16)]
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])


def test_top_k_top_p_restrict_support(logits):
    # top_k: all samples must land in each row's k largest logits.
    k = 4
    topk_idx = np.asarray(jax.lax.top_k(logits, k)[1])
    for t in range(32):
        out = np.asarray(_call(logits, temp=10.0, top_k=k, seed=1, step=t))
        for b in range(out.shape[0]):
            assert out[b] in topk_idx[b], (b, out[b])

    # top_p: with one dominant token (p > 0.9) and top_p=0.5 the nucleus is
    # exactly that token.
    peaked = jnp.zeros((2, 16)).at[:, 5].set(10.0)
    for t in range(8):
        out = np.asarray(_call(peaked, temp=1.0, top_p=0.5, seed=2, step=t))
        assert (out == 5).all()


def test_engine_sampled_request_reproducible():
    params = init_params(jax.random.PRNGKey(0), CFG)
    prompt = list(range(3, 12))
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=1234)

    def run():
        eng = Engine(params, CFG, n_slots=2, max_seq=256)
        req = eng.submit(prompt, max_new_tokens=8, sampling=sp)
        eng.run()
        return req.out_tokens

    a, b = run(), run()
    assert a == b, (a, b)
    assert len(a) == 8
    # And a sampled run at high temperature differs from greedy.
    eng = Engine(params, CFG, n_slots=2, max_seq=256)
    greedy = eng.submit(prompt, max_new_tokens=8)
    hot = eng.submit(prompt, max_new_tokens=8,
                     sampling=SamplingParams(temperature=8.0, seed=7))
    eng.run()
    assert greedy.out_tokens != hot.out_tokens


def test_engine_mixed_greedy_and_sampled_batch():
    """A sampled request co-batched with greedy ones must not perturb the
    greedy outputs (per-slot streams are independent)."""
    params = init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, CFG.vocab_size, size=9).tolist()
    n_new = 4

    eng0 = Engine(params, CFG, n_slots=2, max_seq=256)
    ref = eng0.submit(prompt, max_new_tokens=n_new)
    eng0.run()

    eng = Engine(params, CFG, n_slots=2, max_seq=256)
    greedy = eng.submit(prompt, max_new_tokens=n_new)
    eng.submit(prompt, max_new_tokens=n_new,
               sampling=SamplingParams(temperature=5.0, seed=11))
    eng.run()
    assert greedy.out_tokens == ref.out_tokens


def test_top_p_one_keeps_full_support():
    """Regression: with top_p=1.0 a float-cumsum undershoot (sum just below
    1.0) must NOT collapse the nucleus to the argmax — the threshold clamps
    to the actual total mass, so draws are stable under ~1e-6 logit noise
    (the TP-vs-single-device divergence this bug caused)."""
    logits = jax.random.normal(jax.random.PRNGKey(4), (4, 128)) * 2.0
    base = np.asarray(_call(logits, temp=1.0, top_p=1.0, seed=5, step=0))
    for eps in (1e-6, -1e-6, 3e-7):
        out = np.asarray(_call(logits + eps, temp=1.0, top_p=1.0,
                               seed=5, step=0))
        np.testing.assert_array_equal(out, base)
    # And the full-support draw must be able to differ from argmax.
    draws = [np.asarray(_call(logits, temp=3.0, top_p=1.0, seed=5, step=t))
             for t in range(8)]
    am = np.asarray(jnp.argmax(logits, axis=-1))
    assert any(not np.array_equal(d, am) for d in draws)


def test_tp_engine_sampled_matches_single_device():
    """Sampled (and nucleus-filtered) requests must produce identical token
    streams on the TP mesh and on one device."""
    from fa2_jax.parallel import make_mesh

    params = init_params(jax.random.PRNGKey(0), CFG)

    def run(mesh):
        eng = Engine(params, CFG, n_slots=2, max_seq=256, mesh=mesh)
        r1 = eng.submit([7, 8, 9], 5,
                        sampling=SamplingParams(temperature=1.0, seed=3))
        r2 = eng.submit([4, 4, 4, 4], 4,
                        sampling=SamplingParams(temperature=0.7, top_p=0.9,
                                                top_k=40, seed=11))
        eng.run()
        return r1.out_tokens, r2.out_tokens

    assert run(make_mesh(model=2)) == run(None)


def test_engine_reports_logprobs():
    """Every generated token carries its raw-model logprob; greedy tokens'
    logprobs equal log_softmax at the argmax of a recomputed forward."""
    from fa2_jax.models import forward

    params = init_params(jax.random.PRNGKey(0), CFG)
    prompt = [3, 5, 8, 13, 21]
    n_new = 3
    eng = Engine(params, CFG, n_slots=2, max_seq=256)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert len(req.out_logprobs) == len(req.out_tokens) == n_new
    toks = list(prompt)
    for tok, lp in zip(req.out_tokens, req.out_logprobs):
        logits = forward(params, jnp.asarray([toks], jnp.int32), CFG)
        want = float(jax.nn.log_softmax(logits[0, -1])[tok])
        assert abs(lp - want) < 5e-4, (lp, want)
        assert lp <= 0.0
        toks.append(tok)
