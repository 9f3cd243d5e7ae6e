"""Speculative decoding (`runtime/speculative.py`).

Contracts: the emitted stream EQUALS the target model's greedy decode for
any draft model; a perfect draft (draft == target) accepts every proposal
and emits gamma+1 tokens per target pass; stats book-keeping is consistent.
Sampled mode: the accept/resample rule's distribution identity (emitted
token ~ target distribution, for ANY draft distribution) is pinned
statistically on `spec_accept` directly; the end-to-end path is pinned for
determinism, perfect-draft full acceptance, and greedy-limit equivalence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, init_params
from fa2_jax.runtime.sampling import SamplingParams
from fa2_jax.runtime.speculative import (
    SpeculativeDecoder, greedy_reference, spec_accept,
)

TCFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=128, max_seq_len=256, dtype=jnp.float32,
)
DCFG = LlamaConfig(
    vocab_size=128, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
    hidden_dim=64, max_seq_len=256, dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def tparams():
    return init_params(jax.random.PRNGKey(0), TCFG)


@pytest.fixture(scope="module")
def dparams():
    return init_params(jax.random.PRNGKey(1), DCFG)


def test_perfect_draft_accepts_everything(tparams):
    prompt = list(range(5, 14))
    n_new = 13
    ref = greedy_reference(tparams, TCFG, prompt, n_new, max_seq=256)
    dec = SpeculativeDecoder(tparams, TCFG, tparams, TCFG, gamma=3,
                             max_seq=256)
    out, stats = dec.generate(prompt, n_new)
    assert out == ref, (out, ref)
    # draft == target: every proposal verified, gamma+1 tokens per pass
    # (modulo the final truncated round).
    assert stats.acceptance_rate == 1.0
    assert stats.target_calls == -(-(n_new - 1) // (dec.gamma + 1))


def test_weak_draft_still_exact(tparams, dparams):
    """An unrelated (randomly initialized) draft must not change the output
    stream — only the speedup."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    n_new = 12
    ref = greedy_reference(tparams, TCFG, prompt, n_new, max_seq=256)
    for gamma in (1, 4):
        dec = SpeculativeDecoder(tparams, TCFG, dparams, DCFG, gamma=gamma,
                                 max_seq=256)
        out, stats = dec.generate(prompt, n_new)
        assert out == ref, (gamma, out, ref)
        assert stats.emitted == n_new
        assert 0.0 <= stats.acceptance_rate <= 1.0
        # Every round emits at least the target's own token.
        assert stats.emitted >= stats.rounds


def test_eos_truncates_mid_round(tparams):
    prompt = list(range(7))
    ref = greedy_reference(tparams, TCFG, prompt, 12, max_seq=256)
    eos = ref[4]
    want = ref[: ref.index(eos) + 1]
    dec = SpeculativeDecoder(tparams, TCFG, tparams, TCFG, gamma=4,
                             max_seq=256, eos_id=eos)
    out, _ = dec.generate(prompt, 12)
    assert out == want, (out, want)


# ---------------------------------------------------------------------------
# Speculative sampling
# ---------------------------------------------------------------------------

def _tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def test_spec_accept_first_token_distribution():
    """The speculative-sampling theorem, checked empirically: the first
    emitted token (proposal if accepted, else residual resample) is
    distributed exactly as the TARGET distribution p_0 — for a draft q that
    is deliberately very different from p."""
    V, gamma, N = 8, 3, 6000
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(V), size=gamma + 1).astype(np.float32)
    q = rng.dirichlet(np.full(V, 0.3), size=gamma).astype(np.float32)
    p_d, q_d = jnp.asarray(p), jnp.asarray(q)

    @jax.jit
    def one(key):
        kq, ka = jax.random.split(key)
        # Draw each proposal from its draft row (as the decoder does).
        props = jax.vmap(
            lambda r, kk: jax.random.categorical(kk, jnp.log(r))
        )(q_d, jax.random.split(kq, gamma)).astype(jnp.int32)
        k, nxt = spec_accept(p_d, q_d, props, ka)
        first = jnp.where(k > 0, props[0], nxt)
        return first, k

    keys = jax.random.split(jax.random.PRNGKey(42), N)
    firsts, ks = jax.vmap(one)(keys)
    emp = np.bincount(np.asarray(firsts), minlength=V) / N
    assert _tv(emp, p[0]) < 0.03, (emp, p[0])
    # Sanity: with a mismatched draft, both accept and reject must occur.
    ks = np.asarray(ks)
    assert (ks == 0).any() and (ks > 0).any()


def test_spec_accept_full_accept_bonus_row():
    """draft == target => every proposal accepted (k == gamma) and the
    bonus token is drawn from the target's LAST row."""
    V, gamma, N = 8, 2, 6000
    rng = np.random.default_rng(1)
    p = rng.dirichlet(np.ones(V), size=gamma + 1).astype(np.float32)
    q = p[:gamma]
    p_d, q_d = jnp.asarray(p), jnp.asarray(q)

    @jax.jit
    def one(key):
        kq, ka = jax.random.split(key)
        props = jax.vmap(
            lambda r, kk: jax.random.categorical(kk, jnp.log(r))
        )(q_d, jax.random.split(kq, gamma)).astype(jnp.int32)
        k, nxt = spec_accept(p_d, q_d, props, ka)
        return k, nxt

    ks, bonus = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(7), N))
    assert bool((ks == gamma).all())
    emp = np.bincount(np.asarray(bonus), minlength=V) / N
    assert _tv(emp, p[gamma]) < 0.03


def test_sampled_generate_deterministic_and_in_vocab(tparams, dparams):
    prompt = [2, 7, 1, 8]
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=11)
    dec = SpeculativeDecoder(tparams, TCFG, dparams, DCFG, gamma=3,
                             max_seq=256)
    out1, st1 = dec.generate(prompt, 10, sampling=sp)
    out2, _ = dec.generate(prompt, 10, sampling=sp)
    assert out1 == out2
    assert len(out1) == 10 and all(0 <= t < TCFG.vocab_size for t in out1)
    assert st1.emitted >= st1.rounds
    out3, _ = dec.generate(prompt, 10,
                           sampling=SamplingParams(temperature=0.9, seed=12))
    assert out3 != out1  # a different seed must decouple the stream


def test_sampled_perfect_draft_accepts_everything(tparams):
    """draft == target: p == q at every proposal row => zero rejection
    probability, so acceptance is exactly 1.0 through the real model path."""
    dec = SpeculativeDecoder(tparams, TCFG, tparams, TCFG, gamma=3,
                             max_seq=256)
    out, stats = dec.generate([5, 6, 7], 12,
                              sampling=SamplingParams(temperature=1.0, seed=3))
    assert len(out) == 12
    assert stats.acceptance_rate == 1.0


def test_sampling_temperature_zero_routes_to_greedy(tparams, dparams):
    prompt = [3, 1, 4, 1, 5]
    ref = greedy_reference(tparams, TCFG, prompt, 8, max_seq=256)
    dec = SpeculativeDecoder(tparams, TCFG, dparams, DCFG, gamma=2,
                             max_seq=256)
    out, _ = dec.generate(prompt, 8, sampling=SamplingParams())
    assert out == ref
