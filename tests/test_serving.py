"""Continuous-batching engine: scheduling correctness and greedy-decode
parity with the plain full forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, forward, init_params
from fa2_jax.runtime import Engine

CFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=128, max_seq_len=256, dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def greedy_reference(params, prompt, n_new):
    """Greedy decode via repeated full forward passes (slow oracle)."""
    tokens = list(prompt)
    for _ in range(n_new):
        logits = forward(params, jnp.asarray([tokens], jnp.int32), CFG)
        tokens.append(int(jnp.argmax(logits[0, -1])))
    return tokens[len(prompt):]


@pytest.mark.parametrize("qdtype", [None])
def test_engine_matches_full_forward_greedy(params, qdtype):
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, CFG.vocab_size, size=9).tolist()
    n_new = 3
    ref = greedy_reference(params, prompt, n_new)

    eng = Engine(params, CFG, n_slots=2, max_seq=256, qdtype=qdtype)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert req.done
    assert req.out_tokens == ref, (req.out_tokens, ref)


def test_engine_continuous_batching_many_requests(params):
    rng = np.random.RandomState(1)
    eng = Engine(params, CFG, n_slots=2, max_seq=256, qdtype=jnp.int8)
    reqs = [
        eng.submit(rng.randint(0, CFG.vocab_size, size=n).tolist(), max_new_tokens=m)
        for n, m in [(5, 4), (11, 7), (3, 3), (20, 5), (7, 6)]
    ]
    stats = eng.run()
    assert all(r.done for r in reqs)
    for r in reqs:
        assert len(r.out_tokens) == r.max_new_tokens
    assert stats.decode_tokens > 0 and stats.prefill_tokens == 5 + 11 + 3 + 20 + 7


def test_engine_quantized_matches_unquantized_closely(params):
    """INT8 KV engine should track the bf16 engine's greedy path on a short
    generation (small model, mild quant noise)."""
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, CFG.vocab_size, size=12).tolist()
    outs = {}
    for qdtype in (None, jnp.int8):
        eng = Engine(params, CFG, n_slots=1, max_seq=256, qdtype=qdtype)
        req = eng.submit(prompt, max_new_tokens=4)
        eng.run()
        outs[qdtype] = req.out_tokens
    matches = sum(a == b for a, b in zip(outs[None], outs[jnp.int8]))
    assert matches >= 2, outs


@pytest.mark.parametrize("qdtype", [None, jnp.int8])
def test_engine_paged_matches_full_forward_greedy(params, qdtype):
    """Paged-cache engine must reproduce the dense greedy path, and finished
    requests must return their pages to the shared pool."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, CFG.vocab_size, size=9).tolist()
    n_new = 3
    ref = greedy_reference(params, prompt, n_new)

    eng = Engine(params, CFG, n_slots=2, max_seq=256, qdtype=qdtype, paged=True)
    free0 = eng.pcache.free_pages
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert req.done
    if qdtype is None:
        assert req.out_tokens == ref, (req.out_tokens, ref)
    else:
        assert sum(a == b for a, b in zip(req.out_tokens, ref)) >= 2
    assert eng.pcache.free_pages == free0  # pages released on completion


def test_engine_paged_pool_overcommit(params):
    """A pool smaller than slots x max_seq serves requests sequentially."""
    rng = np.random.RandomState(4)
    # 2 slots x 256 max_seq, but only enough pages for ~1.5 sequences.
    eng = Engine(params, CFG, n_slots=2, max_seq=256, paged=True, n_pages=4)
    reqs = [eng.submit(rng.randint(0, CFG.vocab_size, size=70).tolist(),
                       max_new_tokens=3) for _ in range(3)]
    stats = eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert stats.decode_tokens > 0


def test_engine_long_generation_varied_tokens():
    """Regression: `last_tokens` must advance every decode step. The default
    tiny model degenerates to a constant token (which masked a stale-token
    bug); this config generates a VARIED greedy sequence, so feeding a stale
    token diverges immediately."""
    cfg = LlamaConfig(
        vocab_size=512, dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=192, max_seq_len=256, dtype=jnp.float32, rope_theta=100.0,
    )
    params_v = init_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 512, size=11).tolist()
    toks = list(prompt)
    for _ in range(8):
        logits = forward(params_v, jnp.asarray([toks], jnp.int32), cfg)
        toks.append(int(jnp.argmax(logits[0, -1])))
    ref = toks[len(prompt):]
    assert len(set(ref)) >= 3, "test config must generate varied tokens"
    for paged in (False, True):
        eng = Engine(params_v, cfg, n_slots=2, max_seq=256, paged=paged)
        req = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        assert req.out_tokens == ref, (paged, req.out_tokens, ref)


def test_engine_paged_preemption_mid_generation(params):
    """When the page pool exhausts mid-generation, a victim sequence is
    preempted (pages released, progress folded into its prompt) and later
    resumes to the same greedy result."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, CFG.vocab_size, size=100).tolist() for _ in range(2)]
    refs = [greedy_reference(params, p, 40) for p in prompts]

    # page_size=128 after clamping; 3 usable pages for 2 slots that each
    # need 2 pages to finish (100 prompt + 40 generated > 128).
    eng = Engine(params, CFG, n_slots=2, max_seq=256, paged=True, n_pages=4)
    reqs = [eng.submit(p, max_new_tokens=40) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    for r, ref in zip(reqs, refs):
        assert r.out_tokens == ref, (r.out_tokens, ref)


def test_engine_sliding_window_matches_full_forward():
    """Serving with a Mistral-style sliding window must reproduce the
    windowed training forward's greedy path — prefill AND decode honor
    cfg.sliding_window (the decode kernel masks/skips pre-window blocks)."""
    cfg = LlamaConfig(
        vocab_size=512, dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=192, max_seq_len=256, dtype=jnp.float32, rope_theta=100.0,
        sliding_window=24,
    )
    params_w = init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 512, size=40).tolist()
    toks = list(prompt)
    for _ in range(8):
        logits = forward(params_w, jnp.asarray([toks], jnp.int32), cfg)
        toks.append(int(jnp.argmax(logits[0, -1])))
    ref = toks[len(prompt):]
    for paged in (False, True):
        eng = Engine(params_w, cfg, n_slots=2, max_seq=256, paged=paged)
        req = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        assert req.out_tokens == ref, (paged, req.out_tokens, ref)


def test_engine_chunked_prefill_matches_unchunked(params):
    """prefill_chunk: long prompts prefilled in bounded chunks across steps
    produce EXACTLY the unchunked engine's greedy tokens."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, CFG.vocab_size, size=n).tolist()
               for n in (200, 5, 150)]

    def run(**kw):
        eng = Engine(params, CFG, n_slots=2, max_seq=256, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        return [r.out_tokens for r in reqs]

    assert run() == run(prefill_chunk=128)


def test_engine_chunked_prefill_interleaves_decode(params):
    """While a long prompt prefills chunk-by-chunk, other slots keep
    decoding (the long prompt no longer stalls active generations)."""
    rng = np.random.RandomState(4)
    eng = Engine(params, CFG, n_slots=2, max_seq=256, prefill_chunk=128)
    short = eng.submit(rng.randint(0, CFG.vocab_size, size=5).tolist(), 20)
    eng.step()
    assert len(short.out_tokens) >= 1
    n_before = len(short.out_tokens)
    long_req = eng.submit(rng.randint(0, CFG.vocab_size, size=250).tolist(), 4)
    eng.step()   # long: chunk 1 of 2; short: one decode step
    assert eng._prefilling and not long_req.out_tokens
    assert len(short.out_tokens) == n_before + 1
    eng.step()   # long: final chunk -> first token, then it joins the
    # same step's decode for its second (exactly like the unchunked path,
    # where admit-prefill and the same step's decode both emit).
    assert not eng._prefilling and len(long_req.out_tokens) == 2
    assert len(short.out_tokens) == n_before + 2
    eng.run()
    assert long_req.done and short.done


def test_per_request_stop_ids(params):
    """Generation halts when any per-request stop token is emitted (token
    kept, like eos); other requests are unaffected."""
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, CFG.vocab_size, size=9).tolist()
    eng = Engine(params, CFG, n_slots=2, max_seq=256)
    free_run = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    assert len(free_run.out_tokens) == 8
    stop_tok = free_run.out_tokens[3]

    eng2 = Engine(params, CFG, n_slots=2, max_seq=256)
    stopped = eng2.submit(prompt, max_new_tokens=8, stop_ids={stop_tok})
    other = eng2.submit(prompt, max_new_tokens=8)
    eng2.run()
    assert stopped.out_tokens == free_run.out_tokens[:4]
    assert other.out_tokens == free_run.out_tokens


@pytest.mark.parametrize("paged", [False, True])
def test_batched_admission_matches_sequential(params, paged):
    """Same-bucket prompts admitted in ONE batched prefill dispatch must
    produce exactly the tokens of one-at-a-time admission."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, CFG.vocab_size, size=n).tolist()
               for n in (9, 12, 10, 11, 33, 40)]

    eng1 = Engine(params, CFG, n_slots=1, max_seq=256, paged=paged)
    seq = [eng1.submit(p, max_new_tokens=3) for p in prompts]
    eng1.run()

    engN = Engine(params, CFG, n_slots=8, max_seq=256, paged=paged)
    bat = [engN.submit(p, max_new_tokens=3) for p in prompts]
    engN.run()
    assert [r.out_tokens for r in bat] == [r.out_tokens for r in seq]
    # The batch path actually ran: a ("batch", bucket, N) program compiled
    # (four 16-bucket prompts -> N=4, two 64-bucket -> N=2).
    keys = [k for k in engN._prefill_cache if isinstance(k, tuple)
            and k[0] == "batch"]
    assert ("batch", 64, 4) in keys and ("batch", 64, 2) in keys, keys
