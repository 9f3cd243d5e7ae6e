"""Speculative decoding (draft-and-verify) on the KV-cache kernels.

A small draft model proposes `gamma` tokens autoregressively; the target
model verifies all of them in ONE cached forward over gamma+1 positions
(`flash_attn_with_kv_cache` exercises the forward kernel's global position
offsets, `ops/attention.py:275`). Every round emits between 1 and gamma+1
tokens while costing one target pass.

Two verification modes:

- **Greedy** (default, `sampling=None` or temperature 0): the longest
  proposal prefix matching the target's argmaxes is accepted, plus the
  target's own next token. **Output is exactly the target model's greedy
  decode**, which the tests pin against the token-by-token path.
- **Sampled** (`sampling=SamplingParams(temperature>0, ...)`): standard
  speculative *sampling* — draft proposals are drawn from the draft's
  (temperature/top-k/top-p-adjusted) distribution q, each is accepted with
  probability min(1, p(x)/q(x)) under the equally-adjusted target
  distribution p, and the first rejection resamples from the normalized
  residual max(p-q, 0). By the speculative-sampling theorem the emitted
  stream is distributed EXACTLY as target-only sampling (the distribution
  identity is pinned statistically by `tests/test_speculative.py`). The
  whole draft loop runs as one jitted `lax.scan` and verify+accept as one
  jitted call, so a round costs two device dispatches regardless of gamma
  (per-draft-step host hops would each cost a host sync).

Economics: single-token decode is bandwidth-bound (the whole KV cache streams
per token), and a gamma+1-row verify pass streams the same bytes — so when
the draft is cheap and acceptance is decent, tokens/s approaches
(accepted+1)x the sequential rate. Rollback is free by construction: caches
are fixed buffers addressed by an explicit length, so rejecting tokens just
means not advancing `len` (stale rows are overwritten by the next write at
that position — the same contract the serving engine relies on).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import jax
import jax.numpy as jnp

from fa2_jax.models.llama import (
    LlamaConfig, forward_with_cache, init_kv_cache,
)
from fa2_jax.runtime.sampling import SamplingParams, adjust_logits_row
from fa2_jax.utils import next_power_of_2


def _cached_attn_for(cfg):
    # Config-driven cached attention (window/softcap/scale knobs flow from
    # the model config; see models/llama.py:make_cached_attention_fn).
    from fa2_jax.models.llama import make_cached_attention_fn

    return make_cached_attention_fn(cfg)


def spec_accept(p_probs, q_probs, proposals, key):
    """The speculative-sampling accept/reject/resample rule, as a pure
    function so its distribution identity is unit-testable without models.

    p_probs: [gamma+1, V] target probabilities at the gamma+1 verify rows
             (row i scores proposal i; row gamma is the bonus position).
    q_probs: [gamma, V] draft probabilities the proposals were drawn from.
    proposals: [gamma] i32 draft tokens.
    key: PRNGKey consumed for the gamma accept uniforms + one resample.

    Returns (k, next_token): k proposals accepted (prefix), and the token
    emitted after them — a residual resample at the first rejection, or a
    fresh sample from the bonus row when everything was accepted. Emitting
    proposals[:k] + [next_token] is distributed exactly as k+1 sequential
    target samples (Leviathan et al.; Chen et al. 2023).
    """
    gamma, V = q_probs.shape
    u_key, r_key = jax.random.split(key)
    idx = jnp.arange(gamma)
    p_at = p_probs[idx, proposals]                    # [gamma]
    q_at = q_probs[idx, proposals]
    u = jax.random.uniform(u_key, (gamma,))
    accept = u * q_at < p_at                          # u < min(1, p/q)
    prefix = jnp.cumprod(accept.astype(jnp.int32))
    k = jnp.sum(prefix)                               # in [0, gamma]
    # Resample row: residual max(p-q, 0) at the first rejection, or the
    # bonus target row on full accept. If the residual has zero mass
    # (p == q exactly) fall back to p — unreachable in exact arithmetic
    # (zero residual implies zero rejection probability) but safe under fp.
    j = jnp.minimum(k, gamma - 1)
    residual = jnp.maximum(p_probs[j] - q_probs[j], 0.0)
    residual = jnp.where(jnp.sum(residual) > 0.0, residual, p_probs[j])
    row = jnp.where(k == gamma, p_probs[gamma], residual)
    logits = jnp.where(row > 0.0, jnp.log(row), -jnp.inf)
    next_tok = jax.random.categorical(r_key, logits).astype(jnp.int32)
    return k, next_tok


@dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0       # verify passes (excl. prefill)
    draft_calls: int = 0
    emitted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_call(self) -> float:
        return self.emitted / self.target_calls if self.target_calls else 0.0


class SpeculativeDecoder:
    """Single-sequence greedy speculative decoding.

    `generate(prompt, max_new_tokens)` returns (tokens, SpecStats); the
    token stream equals the target model's greedy decode. Jitted widths are
    bounded: pow-2 prefill buckets, width-1 draft steps, width-(gamma+1)
    verify steps.
    """

    def __init__(
        self,
        target_params, target_cfg: LlamaConfig,
        draft_params, draft_cfg: LlamaConfig,
        gamma: int = 4,
        max_seq: int = 2048,
        eos_id: Optional[int] = None,
    ):
        assert gamma >= 1
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.gamma = gamma
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._jit_cache = {}

    def _step(self, width: int, cfg_tag: str):
        """Jitted cached forward for a fixed token width."""
        key = (width, cfg_tag)
        if key not in self._jit_cache:
            cfg = self.tcfg if cfg_tag == "t" else self.dcfg

            def f(params, tokens, caches, cache_len):
                logits, caches = forward_with_cache(
                    params, tokens, cfg, caches, cache_len,
                    _cached_attn_for(cfg))
                return logits, caches

            self._jit_cache[key] = jax.jit(f, donate_argnums=(2,))
        return self._jit_cache[key]

    def _draft_scan(self):
        """Jitted: draw all gamma draft proposals in ONE dispatch.

        lax.scan over width-1 cached draft forwards, sampling each proposal
        from the adjusted draft distribution; returns the proposals, the
        full draft probability rows (needed by the verify-side accept
        test), and the advanced draft caches.
        """
        if "dscan" not in self._jit_cache:
            cfg, gamma = self.dcfg, self.gamma

            def f(params, last_tok, caches, d_len, samp, root_key):
                temp, top_k, top_p = samp

                def step(carry, i):
                    caches, tok = carry
                    logits, caches = forward_with_cache(
                        params, tok[None, None], cfg, caches, d_len + i,
                        _cached_attn_for(cfg))
                    adj = adjust_logits_row(logits[0, 0], temp, top_k, top_p)
                    q_row = jax.nn.softmax(adj)
                    nxt = jax.random.categorical(
                        jax.random.fold_in(root_key, i), adj
                    ).astype(jnp.int32)
                    return (caches, nxt), (nxt, q_row)

                (caches, _), (props, q) = jax.lax.scan(
                    step, (caches, last_tok), jnp.arange(gamma))
                return props, q, caches

            self._jit_cache["dscan"] = jax.jit(f, donate_argnums=(2,))
        return self._jit_cache["dscan"]

    def _verify_sampled(self):
        """Jitted: one target pass over gamma+1 rows + accept/resample."""
        if "vsamp" not in self._jit_cache:
            cfg = self.tcfg

            def f(params, row, caches, t_len, props, q, samp, root_key):
                temp, top_k, top_p = samp
                logits, caches = forward_with_cache(
                    params, row, cfg, caches, t_len, _cached_attn_for(cfg))
                adj = jax.vmap(
                    lambda l: adjust_logits_row(l, temp, top_k, top_p)
                )(logits[0])
                p_probs = jax.nn.softmax(adj, axis=-1)
                k, nxt = spec_accept(p_probs, q, props, root_key)
                return (k, nxt), caches

            self._jit_cache["vsamp"] = jax.jit(f, donate_argnums=(2,))
        return self._jit_cache["vsamp"]

    def generate(self, prompt: List[int], max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None):
        if sampling is not None and sampling.temperature > 0.0:
            return self._generate_sampled(prompt, max_new_tokens, sampling)
        L = len(prompt)
        assert L + max_new_tokens + self.gamma + 1 <= self.max_seq
        t_caches = init_kv_cache(self.tcfg, 1, self.max_seq)
        d_caches = init_kv_cache(self.dcfg, 1, self.max_seq)
        stats = SpecStats()

        # Prefill both models on the (pow-2 padded) prompt.
        s_pad = max(64, next_power_of_2(L))
        padded = jnp.zeros((1, s_pad), jnp.int32).at[0, :L].set(
            jnp.asarray(prompt, jnp.int32))
        tl, t_caches = self._step(s_pad, "t")(
            self.tp, padded, t_caches, jnp.int32(0))
        dl, d_caches = self._step(s_pad, "d")(
            self.dp, padded, d_caches, jnp.int32(0))
        # Cache rows past L hold padding KV; lengths below never expose them.
        t_len = d_len = L
        last = int(jnp.argmax(tl[0, L - 1]))
        out = [last]

        draft1 = self._step(1, "d")
        verify = self._step(self.gamma + 1, "t")

        while len(out) < max_new_tokens and (
                self.eos_id is None or out[-1] != self.eos_id):
            # Draft proposes gamma tokens from the accepted state.
            proposals = []
            cur, dl_len = last, d_len
            for _ in range(self.gamma):
                dl, d_caches = draft1(
                    self.dp, jnp.asarray([[cur]], jnp.int32), d_caches,
                    jnp.int32(dl_len))
                cur = int(jnp.argmax(dl[0, 0]))
                proposals.append(cur)
                dl_len += 1
                stats.draft_calls += 1

            # Target verifies all proposals in one pass over gamma+1 rows.
            row = jnp.asarray([[last] + proposals], jnp.int32)
            tl, t_caches = verify(self.tp, row, t_caches, jnp.int32(t_len))
            greedy = [int(g) for g in jnp.argmax(tl[0], axis=-1)]
            stats.target_calls += 1
            stats.rounds += 1
            stats.proposed += self.gamma

            k = 0
            while k < self.gamma and proposals[k] == greedy[k]:
                k += 1
            stats.accepted += k
            new = proposals[:k] + [greedy[k]]
            if self.eos_id is not None and self.eos_id in new:
                new = new[: new.index(self.eos_id) + 1]
            new = new[: max_new_tokens - len(out)]
            out.extend(new)
            if k == self.gamma:
                # Full accept: the draft cache holds KV for
                # [last, d1..d_{gamma-1}] but not d_gamma (it was proposed,
                # never fed). Backfill it with one discarded draft step —
                # otherwise the claimed length covers a stale row and every
                # subsequent proposal round diverges.
                _, d_caches = draft1(
                    self.dp, jnp.asarray([[proposals[-1]]], jnp.int32),
                    d_caches, jnp.int32(dl_len))
                stats.draft_calls += 1
            # Advance to the accepted frontier; the target cache holds KV for
            # [last] + proposals — k+1 of those rows are now committed.
            t_len += k + 1
            d_len = t_len
            last = out[-1]

        stats.emitted = len(out)
        return out, stats

    def _generate_sampled(self, prompt: List[int], max_new_tokens: int,
                          sp: SamplingParams):
        """Speculative sampling: emitted stream ~ target-only sampling.

        Randomness is counter-keyed off `sp.seed` (event 0 = the prefill
        token; round r consumes events 2r+1 for the draft scan and 2r+2 for
        verify/accept), so a (seed, prompt) pair reproduces bitwise.
        """
        L = len(prompt)
        assert L + max_new_tokens + self.gamma + 1 <= self.max_seq
        t_caches = init_kv_cache(self.tcfg, 1, self.max_seq)
        d_caches = init_kv_cache(self.dcfg, 1, self.max_seq)
        stats = SpecStats()
        base = jax.random.PRNGKey(sp.seed)
        samp = (jnp.float32(sp.temperature), jnp.int32(sp.top_k),
                jnp.float32(sp.top_p))

        s_pad = max(64, next_power_of_2(L))
        padded = jnp.zeros((1, s_pad), jnp.int32).at[0, :L].set(
            jnp.asarray(prompt, jnp.int32))
        tl, t_caches = self._step(s_pad, "t")(
            self.tp, padded, t_caches, jnp.int32(0))
        dl, d_caches = self._step(s_pad, "d")(
            self.dp, padded, d_caches, jnp.int32(0))
        t_len = d_len = L
        adj0 = adjust_logits_row(tl[0, L - 1], *samp)
        last = int(jax.random.categorical(jax.random.fold_in(base, 0), adj0))
        out = [last]

        dscan, verify = self._draft_scan(), self._verify_sampled()
        draft1 = self._step(1, "d")
        r = 0
        while len(out) < max_new_tokens and (
                self.eos_id is None or out[-1] != self.eos_id):
            props_d, q, d_caches = dscan(
                self.dp, jnp.int32(last), d_caches, jnp.int32(d_len), samp,
                jax.random.fold_in(base, 2 * r + 1))
            proposals = [int(t) for t in props_d]
            stats.draft_calls += self.gamma

            row = jnp.asarray([[last] + proposals], jnp.int32)
            (k_d, nxt_d), t_caches = verify(
                self.tp, row, t_caches, jnp.int32(t_len), props_d, q, samp,
                jax.random.fold_in(base, 2 * r + 2))
            k, nxt = int(k_d), int(nxt_d)
            stats.target_calls += 1
            stats.rounds += 1
            stats.proposed += self.gamma
            stats.accepted += k

            new = proposals[:k] + [nxt]
            if self.eos_id is not None and self.eos_id in new:
                new = new[: new.index(self.eos_id) + 1]
            new = new[: max_new_tokens - len(out)]
            out.extend(new)
            if k == self.gamma:
                # Full accept: as in the greedy path, the draft cache lacks
                # KV for the last proposal (proposed, never fed) — backfill.
                _, d_caches = draft1(
                    self.dp, jnp.asarray([[proposals[-1]]], jnp.int32),
                    d_caches, jnp.int32(d_len + self.gamma))
                stats.draft_calls += 1
            t_len += k + 1
            d_len = t_len
            last = out[-1]
            r += 1

        stats.emitted = len(out)
        return out, stats


def greedy_reference(params, cfg: LlamaConfig, prompt: List[int],
                     max_new_tokens: int, max_seq: int = 2048,
                     eos_id: Optional[int] = None) -> List[int]:
    """Token-by-token greedy decode through the same cached path (the
    equivalence oracle for the speculative decoder)."""
    dec = SpeculativeDecoder(params, cfg, params, cfg, gamma=1,
                             max_seq=max_seq, eos_id=eos_id)
    caches = init_kv_cache(cfg, 1, max_seq)
    L = len(prompt)
    s_pad = max(64, next_power_of_2(L))
    padded = jnp.zeros((1, s_pad), jnp.int32).at[0, :L].set(
        jnp.asarray(prompt, jnp.int32))
    logits, caches = dec._step(s_pad, "t")(params, padded, caches,
                                           jnp.int32(0))
    cur = int(jnp.argmax(logits[0, L - 1]))
    out = [cur]
    step = dec._step(1, "t")
    n = L
    while len(out) < max_new_tokens and (eos_id is None or out[-1] != eos_id):
        logits, caches = step(params, jnp.asarray([[cur]], jnp.int32),
                              caches, jnp.int32(n))
        cur = int(jnp.argmax(logits[0, 0]))
        out.append(cur)
        n += 1
    return out
