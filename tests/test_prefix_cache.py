"""Automatic prefix caching (`runtime/paged_cache.py` + the paged Engine):
content-addressed full-page sharing with refcounts and LRU eviction, plus
engine-level suffix prefill that must reproduce the cold-path tokens exactly
(shared pages hold the SAME KV the full prefill would recompute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, init_params
from fa2_jax.runtime import Engine
from fa2_jax.runtime.paged_cache import PagedCacheConfig, PagedKVCache

CFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=128, max_seq_len=512, dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


# --------------------------- allocator unit tests --------------------------

def _tiny_pool(n_pages=6, page=128, n_slots=2):
    return PagedKVCache(PagedCacheConfig(
        n_layers=1, n_kv_heads=1, head_dim=128, page_size=page,
        n_pages=n_pages, n_slots=n_slots, max_seq=4 * page,
    ))


def test_match_register_release_cycle():
    pc = _tiny_pool()
    P = pc.cfg.page_size
    prompt = list(range(2 * P + 10))
    assert pc.match_prefix(prompt) == (0, [])

    pc.ensure_capacity(0, len(prompt))
    pc.register_prefix(0, prompt)          # registers 2 full pages
    n, pages = pc.match_prefix(prompt)
    assert n == 2 * P and len(pages) == 2
    # Exact-page-multiple prompts keep one token unprefixed (logits needed).
    assert pc.match_prefix(prompt[: 2 * P]) == (P, pages[:1])

    free_before = pc.free_pages
    pc.release(0)
    # Registered pages stay matchable after release (resident, ref 0).
    assert pc.match_prefix(prompt)[0] == 2 * P
    assert pc.free_pages == free_before + 3  # all 3 pages reusable

    # Attaching bumps refs so eviction can't take the pages.
    n, pages = pc.match_prefix(prompt)
    pc.attach(1, pages)
    assert pc._refs[pages[0]] == 1
    pc.release(1)


def test_lru_eviction_unregisters():
    pc = _tiny_pool(n_pages=4)  # 3 usable pages
    P = pc.cfg.page_size
    prompt_a = [1] * (P + 1)
    pc.ensure_capacity(0, len(prompt_a))    # 2 pages
    pc.register_prefix(0, prompt_a)
    pc.release(0)
    assert pc.match_prefix(prompt_a)[0] == P

    # Claiming all 3 pages must evict A's cached page (LRU).
    pc.ensure_capacity(1, 3 * P)
    assert pc.match_prefix(prompt_a)[0] == 0
    with pytest.raises(MemoryError):
        pc.ensure_capacity(0, P)
    pc.release(1)


def test_shared_page_refcounted_not_evictable():
    pc = _tiny_pool(n_pages=4)
    P = pc.cfg.page_size
    prompt = [7] * (P + 1)
    pc.ensure_capacity(0, len(prompt))
    pc.register_prefix(0, prompt)
    n, pages = pc.match_prefix(prompt)
    pc.attach(1, pages)                      # slot 1 shares slot 0's page
    assert pc._refs[pages[0]] == 2
    pc.release(0)
    assert pc._refs[pages[0]] == 1           # still live via slot 1
    # Pool pressure: only the truly-free page remains; the shared page must
    # survive allocation pressure.
    pc.ensure_capacity(1, 2 * P)
    assert pc._tables[1, 0] == pages[0]
    pc.release(1)
    assert pc.free_pages == 3


# --------------------------- engine end-to-end -----------------------------

def _run(params, prompts, n_new, **kw):
    eng = Engine(params, CFG, n_slots=2, max_seq=512, paged=True,
                 page_size=128, **kw)
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return eng, [r.out_tokens for r in reqs]


def test_prefix_cache_exact_repeat_prompt(params):
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, CFG.vocab_size, size=200).tolist()

    _, cold = _run(params, [prompt], 4)
    eng, outs = _run(params, [prompt, prompt], 4, prefix_cache=True)
    # Both requests decode identical greedy tokens, and the second skipped
    # recomputing one full page (128 tokens) of prompt KV.
    assert outs[0] == cold[0] and outs[1] == cold[0]
    assert eng.stats.prefix_cached_tokens == 128
    assert eng.stats.prefill_tokens == 200 + (200 - 128)


def test_prefix_cache_shared_prefix_different_tail(params):
    rng = np.random.RandomState(4)
    head = rng.randint(0, CFG.vocab_size, size=256).tolist()
    a = head + rng.randint(0, CFG.vocab_size, size=30).tolist()
    b = head + rng.randint(0, CFG.vocab_size, size=50).tolist()

    _, cold = _run(params, [a, b], 4)
    eng, warm = _run(params, [a, b], 4, prefix_cache=True)
    assert warm == cold
    # b matched a's two full head pages (the engine admits a first).
    assert eng.stats.prefix_cached_tokens == 256


def test_prefix_cache_survives_completion_and_slot_reuse(params):
    """Pages registered by a FINISHED request (slot released) still serve
    later requests — residency outlives the slot."""
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, CFG.vocab_size, size=140).tolist()
    eng = Engine(params, CFG, n_slots=1, max_seq=512, paged=True,
                 page_size=128, prefix_cache=True)
    r1 = eng.submit(prompt, max_new_tokens=3)
    eng.run()
    r2 = eng.submit(prompt, max_new_tokens=3)
    eng.run()
    assert r1.out_tokens == r2.out_tokens
    assert eng.stats.prefix_cached_tokens == 128


def test_prefix_cache_multiturn_generated_tokens_reused(params):
    """Finished requests register their GENERATED tokens' full pages too, so
    a follow-up turn whose prompt embeds the previous answer hits the cache
    across the prompt/generation boundary."""
    rng = np.random.RandomState(7)
    p1 = rng.randint(0, CFG.vocab_size, size=100).tolist()
    eng = Engine(params, CFG, n_slots=1, max_seq=512, paged=True,
                 page_size=128, prefix_cache=True)
    r1 = eng.submit(p1, max_new_tokens=40)
    eng.run()
    # Turn 2: previous turn's full transcript + new user tokens.
    p2 = p1 + r1.out_tokens + rng.randint(0, CFG.vocab_size, size=20).tolist()
    r2 = eng.submit(p2, max_new_tokens=4)
    eng.run()
    # 100 prompt + 39 fed generated tokens = 139 valid KV -> one full page.
    assert eng.stats.prefix_cached_tokens == 128
    # Cold engine on p2 must produce identical tokens.
    eng2 = Engine(params, CFG, n_slots=1, max_seq=512, paged=True,
                  page_size=128)
    r2c = eng2.submit(p2, max_new_tokens=4)
    eng2.run()
    assert r2.out_tokens == r2c.out_tokens


def test_prefix_cache_quantized_pool(params):
    """Prefix sharing composes with int8 KV storage (pages carry quantized
    values + scales; the suffix path dequantizes the gathered view)."""
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, CFG.vocab_size, size=150).tolist()
    _, cold = _run(params, [prompt, prompt], 4, qdtype=jnp.int8)
    eng, warm = _run(params, [prompt, prompt], 4, qdtype=jnp.int8,
                     prefix_cache=True)
    assert warm == cold
    assert eng.stats.prefix_cached_tokens == 128


def test_paged_chunked_prefill_matches_unchunked(params):
    """Chunked prefill on the PAGED cache (suffix-prefill program per chunk)
    must reproduce the one-shot prefill tokens, with decode interleaving."""
    rng = np.random.RandomState(8)
    long_p = rng.randint(0, CFG.vocab_size, size=300).tolist()
    short_p = rng.randint(0, CFG.vocab_size, size=6).tolist()

    def run(**kw):
        eng = Engine(params, CFG, n_slots=2, max_seq=512, paged=True,
                     page_size=128, **kw)
        r_long = eng.submit(long_p, max_new_tokens=4)
        r_short = eng.submit(short_p, max_new_tokens=12)
        eng.run()
        return r_long.out_tokens, r_short.out_tokens

    base = run()
    chunked = run(prefill_chunk=128)
    assert chunked == base


def test_paged_chunked_prefill_composes_with_prefix_cache(params):
    """A repeated long prompt under chunked+prefix serving: the second
    request's chunk cursor starts past the cached pages."""
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, CFG.vocab_size, size=300).tolist()
    eng = Engine(params, CFG, n_slots=1, max_seq=512, paged=True,
                 page_size=128, prefill_chunk=128, prefix_cache=True)
    r1 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    r2 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    assert r2.out_tokens == r1.out_tokens
    # 2 full pages (256 tokens) of the 300-token prompt came from the cache.
    assert eng.stats.prefix_cached_tokens == 256


def test_sliding_window_frees_dead_pages():
    """Windowed models (all layers): pages entirely behind the window return
    to the pool mid-generation (rolling-buffer memory), with token parity
    against the contiguous-cache engine."""
    import dataclasses

    cfg_w = dataclasses.replace(CFG, sliding_window=64)
    params_w = init_params(jax.random.PRNGKey(1), cfg_w)
    rng = np.random.RandomState(10)
    prompt = rng.randint(0, CFG.vocab_size, size=250).tolist()

    ref_eng = Engine(params_w, cfg_w, n_slots=1, max_seq=512)
    ref = ref_eng.submit(prompt, max_new_tokens=10)
    ref_eng.run()

    eng = Engine(params_w, cfg_w, n_slots=1, max_seq=512, paged=True,
                 page_size=128)
    req = eng.submit(prompt, max_new_tokens=10)
    free_seen = []
    while not req.done:
        eng.step()
        free_seen.append(eng.pcache.free_pages)
    assert req.out_tokens == ref.out_tokens
    # Prefill allocated ceil(256/128)=2 pages; the first decode step frees
    # page 0 (tokens 0..127 are all behind the 64-token window at lens=250).
    total = eng.pcache.cfg.n_pages - 1
    assert free_seen[0] == total - 1, free_seen  # one live page remains +1 new
    assert eng.pcache._slot_freed == [0]  # released on completion


def test_gemma2_style_knobs_compose_with_prefix_cache():
    """Alternating windows + attention softcap + post-norms + prefix caching
    + paged serving, all at once: warm tokens == cold tokens, and no pages
    are window-freed (alt_window models have full-attention layers that
    still need the whole history)."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG, sliding_window=63, alt_window=True, attn_softcap=30.0,
        attn_scale=0.2)
    params = init_params(jax.random.PRNGKey(2), cfg)
    for layer in params["layers"]:
        layer["post_attn_norm"] = jnp.ones((cfg.dim,), jnp.float32)
        layer["post_mlp_norm"] = jnp.ones((cfg.dim,), jnp.float32)
    rng = np.random.RandomState(12)
    prompt = rng.randint(0, CFG.vocab_size, size=200).tolist()

    def run(prefix_cache):
        eng = Engine(params, cfg, n_slots=2, max_seq=512, paged=True,
                     page_size=128, prefix_cache=prefix_cache)
        reqs = [eng.submit(prompt, max_new_tokens=4) for _ in range(2)]
        eng.run()
        return eng, [r.out_tokens for r in reqs]

    _, cold = run(False)
    eng, warm = run(True)
    assert warm == cold
    assert eng.stats.prefix_cached_tokens == 128
    assert eng.pcache._slot_freed == [0, 0]  # alt_window: nothing freed


def test_moe_through_paged_engine_with_prefix_cache():
    """MoE layer pytrees served through the paged engine with prefix caching
    (the dense batch-invariant MLP path + shared attention pages)."""
    from fa2_jax.models import moe

    mcfg = moe.MoEConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=512, dtype=jnp.float32,
        n_experts=4, top_k=2)
    mparams = moe.init_params(jax.random.PRNGKey(3), mcfg)
    rng = np.random.RandomState(13)
    prompt = rng.randint(0, 128, size=150).tolist()

    def run(**kw):
        eng = Engine(mparams, mcfg, n_slots=2, max_seq=512, paged=True,
                     page_size=128, **kw)
        reqs = [eng.submit(prompt, max_new_tokens=4) for _ in range(2)]
        eng.run()
        return eng, [r.out_tokens for r in reqs]

    _, cold = run()
    eng, warm = run(prefix_cache=True)
    assert warm == cold
    assert eng.stats.prefix_cached_tokens == 128
