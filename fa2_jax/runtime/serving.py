"""Continuous-batching serving engine.

North-star surface (BASELINE.json: "serves continuous-batched decode"):
a slot-based scheduler — new requests are prefilled into free KV-cache slots
while the decode loop keeps stepping every active slot each iteration, so
short and long generations share the batch without head-of-line blocking.

All device work is jitted: prompt prefill per power-of-two length bucket
(bounded recompiles) and ONE batched decode step over all slots (inactive
slots step harmlessly and are ignored). Greedy decode by default, with\nper-request temperature/top-k/top-p sampling (`runtime/sampling.py`);\ntokens/s metrics.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fa2_jax.models.llama import (
    LlamaConfig, decode_step, prefill_forward,
)
from fa2_jax.runtime.kv_cache import KVCacheConfig, init_cache, write_kv
from fa2_jax.runtime.sampling import (
    GREEDY, SamplingParams, greedy_tokens_with_logprobs,
    sample_tokens_with_logprobs,
)
from fa2_jax.utils import next_power_of_2


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    # Raw-model logprob of each generated token (scoring convention:
    # temperature/truncation-independent), parallel to out_tokens.
    out_logprobs: List[float] = field(default_factory=list)
    done: bool = False
    # Count of out_tokens already folded into `prompt` by preemption
    # (`Engine._preempt`): keeps end-of-request prefix registration from
    # double-counting the pre-preemption generation.
    folded: int = 0
    # Per-request stop tokens (checked in ADDITION to the engine eos_id);
    # generation ends when any is emitted (the stop token is kept in
    # out_tokens, matching the eos convention).
    stop_ids: Optional[frozenset] = None
    # Per-request sampling (temperature/top-k/top-p/seed); GREEDY default.
    # Deterministic by construction: token i comes from fold_in(seed, i)
    # (`runtime/sampling.py`), so retries and preemption-resumes reproduce.
    sampling: SamplingParams = GREEDY


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    # Prompt tokens whose KV came from the prefix cache (never recomputed).
    prefix_cached_tokens: int = 0
    wall_s: float = 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s else 0.0


class Engine:
    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        n_slots: int = 8,
        max_seq: int = 2048,
        qdtype: Optional[Any] = None,
        eos_id: Optional[int] = None,
        paged: bool = False,
        n_pages: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        page_size: Optional[int] = None,
    ):
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.paged = paged
        # Automatic prefix caching (paged mode): finished sequences' full
        # pages stay resident, content-addressed by token chain hash; a new
        # request whose prompt shares a full-page prefix attaches those pages
        # and prefills only the suffix (`runtime/paged_cache.py`).
        assert not prefix_cache or paged, "prefix_cache requires paged=True"
        self.prefix_cache = prefix_cache
        # Chunked prefill: prompts longer than `prefill_chunk` are admitted
        # immediately but prefilled ONE bounded chunk per engine step,
        # interleaved with decode — long prompts no longer stall active
        # generations. Contiguous caches use `chunk_prefill_step` directly;
        # paged caches run each chunk through the suffix-prefill program
        # (page gather -> chunk prefill -> scatter), composing with prefix
        # caching (a matched prefix just advances the chunk cursor).
        assert prefill_chunk is None or (
            prefill_chunk >= 16 and prefill_chunk & (prefill_chunk - 1) == 0
        ), "prefill_chunk must be a power of two, at least 16"
        self.prefill_chunk = prefill_chunk
        self._prefilling: Dict[int, int] = {}   # slot -> next prompt offset
        # ---- tensor parallelism over the `model` (head) axis -------------
        # BASELINE's scaling target (>= 80% tokens/s 1 -> 2 hosts) needs the
        # serving path itself sharded: every per-step device function runs
        # under shard_map with head-sharded weights and KV caches, psum on
        # the row-parallel projections (`models/llama.py:_psum`), replicated
        # logits/argmax. The host-side scheduler is unchanged.
        self.mesh = mesh
        self.tp = 1
        self._psum_axis = None
        if mesh is not None:
            from fa2_jax.parallel.mesh import AXIS_MODEL

            self.tp = int(mesh.shape[AXIS_MODEL])
            extra = 1
            for name, size in mesh.shape.items():
                if name != AXIS_MODEL:
                    extra *= size
            assert extra == 1, "serving mesh must only have the model axis"
            assert cfg.n_heads % self.tp == 0 and cfg.n_kv_heads % self.tp == 0
            self._psum_axis = AXIS_MODEL if self.tp > 1 else None
        self.cfg_local = (
            dataclasses.replace(
                cfg, n_heads=cfg.n_heads // self.tp,
                n_kv_heads=cfg.n_kv_heads // self.tp,
                head_dim=cfg.hd,
            )
            if self.tp > 1 else cfg
        )
        if paged:
            from fa2_jax.runtime.paged_cache import (
                PagedCacheConfig, PagedKVCache,
            )
            from fa2_jax.utils import round_up_to_multiple

            page = page_size or min(512, max(16, next_power_of_2(max_seq)))
            assert page >= 16 and page & (page - 1) == 0, (
                "page_size must be a power of two, at least 16")
            max_seq_p = round_up_to_multiple(max_seq, page)
            pcfg = PagedCacheConfig(
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, page_size=page,
                # Default pool: fully-committed equivalent (+1 reserved page);
                # size it down to overcommit slots against live tokens.
                n_pages=(n_pages if n_pages is not None
                         else n_slots * (max_seq_p // page) + 1),
                n_slots=n_slots, max_seq=max_seq_p,
                qdtype=qdtype, compute_dtype=cfg.dtype,
            )
            self.pcache = PagedKVCache(pcfg)
            self.kv_cfg = pcfg  # max_seq_padded shim below
        else:
            self.kv_cfg = KVCacheConfig(
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                max_seq=max_seq, n_slots=n_slots, qdtype=qdtype,
                compute_dtype=cfg.dtype,
            )
            self.caches = init_cache(self.kv_cfg)
        self._max_seq_padded = (
            self.kv_cfg.max_seq if paged else self.kv_cfg.max_seq_padded
        )
        # Local (per-shard) cache config + sharded params/caches. Cache
        # leaves are [slots|pages, Hkv, ...]: heads shard on axis 1; scales
        # ([.., Hkv, 1, S]) shard the same axis.
        self.kv_cfg_local = (
            dataclasses.replace(self.kv_cfg,
                                n_kv_heads=self.kv_cfg.n_kv_heads // self.tp)
            if self.tp > 1 else self.kv_cfg
        )
        if self.tp > 1:
            from fa2_jax.parallel.mesh import serving_param_pspecs

            self._pspecs = serving_param_pspecs(params)
            self._cache_spec_leaf = P(None, "model", None, None)
            self.params = jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                params, self._pspecs,
            )
            shard_cache = lambda t: jax.tree.map(
                lambda x: jax.device_put(
                    x, NamedSharding(mesh, self._cache_spec_leaf)), t)
            if paged:
                self.pcache.pools = shard_cache(self.pcache.pools)
            else:
                self.caches = shard_cache(self.caches)
        # Host-side lens mirror: the engine already knows every slot's
        # length exactly, so scheduling reads host memory (a device read is a
        # host sync per step); the device copy is rebuilt per step (one
        # cheap async H2D).
        self.lens_np = np.zeros((n_slots,), np.int32)
        # Per-slot sampling params mirrored on host (rebuilt per step like
        # lens; empty slots keep greedy defaults and their draws are unused).
        self.temp_np = np.zeros((n_slots,), np.float32)
        self.topk_np = np.zeros((n_slots,), np.int32)
        self.topp_np = np.ones((n_slots,), np.float32)
        self.seed_np = np.zeros((n_slots,), np.uint32)
        self.last_tokens = jnp.zeros((n_slots,), jnp.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.stats = EngineStats()

        # params ride as a jit ARGUMENT (not a closure constant — closed-over
        # params would be baked into the HLO as literals, ballooning the
        # program past remote-compile limits).
        def build_decode(greedy):
            fn = partial(self._decode_impl_paged if paged
                         else self._decode_impl, greedy=greedy)
            if self.tp > 1:
                n_extra = 2 if paged else 1  # (pools, tables) vs (caches)
                cspec = jax.tree.map(
                    lambda _: self._cache_spec_leaf,
                    self.pcache.pools if paged else self.caches)
                in_specs = (self._pspecs, P(), cspec) + (P(),) * n_extra \
                    + ((P(),) * 5,)
                fn = jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=in_specs, out_specs=((P(), P()), cspec),
                    check_vma=False,  # pallas outputs carry no vma annotations
                )
            return jax.jit(fn, donate_argnums=(2,))

        # Two decode programs: the greedy-only fast path skips the sampling
        # machinery (two [B, V] sorts + cumsum + categorical per step) —
        # greedy is the engine default, so most decode steps take it. The
        # host picks per step from its sampling-params mirror.
        self._decode = build_decode(False)
        self._decode_greedy = build_decode(True)
        self._prefill_cache: Dict[int, Any] = {}

    # ---------------- jitted device functions ---------------------------

    def _decode_impl(self, params, tokens, caches, lens, samp,
                     greedy=False):
        logits, caches = decode_step(
            params, tokens, self.cfg_local, caches, lens, self.kv_cfg_local,
            psum_axis=self._psum_axis,
        )
        sample = (greedy_tokens_with_logprobs(logits) if greedy
                  else sample_tokens_with_logprobs(logits, *samp))
        return sample, caches

    def _decode_impl_paged(self, params, tokens, pools, tables, lens, samp,
                           greedy=False):
        from fa2_jax.models.llama import paged_decode_step

        logits, pools = paged_decode_step(
            params, tokens, self.cfg_local, pools, tables, lens,
            self.kv_cfg_local, psum_axis=self._psum_axis,
        )
        sample = (greedy_tokens_with_logprobs(logits) if greedy
                  else sample_tokens_with_logprobs(logits, *samp))
        return sample, pools

    def _get_prefill(self, s_pad: int):
        if s_pad not in self._prefill_cache:
            if self.paged:
                from fa2_jax.runtime.paged_cache import write_tokens_paged

                def _prefill(params, tokens, true_len, pools, tables, slot,
                             samp):
                    logits, kvs = prefill_forward(
                        params, tokens, true_len, self.cfg_local,
                        psum_axis=self._psum_axis,
                    )
                    # Write the whole padded prompt through the slot's block
                    # table; per-slot lengths hide padded tail positions.
                    table_row = jax.lax.dynamic_slice_in_dim(tables, slot, 1, 0)
                    new_pools = [
                        write_tokens_paged(pool, table_row, k, v,
                                           jnp.zeros((1,), jnp.int32),
                                           self.kv_cfg_local)
                        for pool, (k, v) in zip(pools, kvs)
                    ]
                    row = jax.lax.dynamic_slice_in_dim(
                        logits[0], true_len[0] - 1, 1, axis=0)
                    tok, lp = sample_tokens_with_logprobs(row, *samp)
                    return (tok[0], lp[0]), new_pools
            else:
                def _prefill(params, tokens, true_len, caches, slot, samp):
                    logits, kvs = prefill_forward(
                        params, tokens, true_len, self.cfg_local,
                        psum_axis=self._psum_axis,
                    )
                    new_caches = []
                    for cache, (k, v) in zip(caches, kvs):
                        # Write the whole padded prompt into the slot's row; the
                        # per-slot length keeps padded tail positions invisible.
                        upd = write_kv(
                            cache_slice(cache, slot), k, v,
                            jnp.zeros((1,), jnp.int32), self.kv_cfg_local,
                        )
                        new_caches.append(cache_write_back(cache, upd, slot))
                    row = jax.lax.dynamic_slice_in_dim(
                        logits[0], true_len[0] - 1, 1, axis=0)
                    tok, lp = sample_tokens_with_logprobs(row, *samp)
                    return (tok[0], lp[0]), new_caches

            fn = _prefill
            if self.tp > 1:
                cspec = jax.tree.map(
                    lambda _: self._cache_spec_leaf,
                    self.pcache.pools if self.paged else self.caches,
                )
                in_specs = (
                    (self._pspecs, P(), P(), cspec, P(), P(), (P(),) * 5)
                    if self.paged
                    else (self._pspecs, P(), P(), cspec, P(), (P(),) * 5)
                )
                fn = jax.shard_map(
                    fn, mesh=self.mesh, in_specs=in_specs,
                    out_specs=((P(), P()), cspec), check_vma=False,  # pallas_call outputs cannot carry vma annotations
                )
            self._prefill_cache[s_pad] = jax.jit(fn, donate_argnums=(3,))
        return self._prefill_cache[s_pad]

    def _get_suffix_prefill(self, c_pad: int, n_ctx_pages: int):
        """Jitted prompt-SUFFIX prefill for a slot whose leading pages came
        from the prefix cache: gather the slot's first `n_ctx_pages` pages
        into a contiguous single-slot view, run `chunk_prefill_step` (the
        suffix's queries attend to cached prefix + suffix via the forward
        kernel's global q_offset), and scatter the written pages back into
        the shared pool. Keyed by (suffix width, page count) so every shape
        compiles once."""
        key = ("suffix", c_pad, n_ctx_pages)
        if key not in self._prefill_cache:
            from fa2_jax.models.llama import chunk_prefill_step

            page = self.kv_cfg.page_size
            S_view = n_ctx_pages * page
            Hkv = self.kv_cfg_local.n_kv_heads
            Dp = self.kv_cfg.head_dim_padded
            shim = KVCacheConfig(
                n_layers=self.cfg.n_layers, n_kv_heads=Hkv,
                head_dim=self.kv_cfg.head_dim, max_seq=S_view, n_slots=1,
                qdtype=self.kv_cfg.qdtype,
                compute_dtype=self.kv_cfg.compute_dtype,
            )

            def _gather(pool, trow):
                view = {}
                for name in ("k", "v"):
                    g = pool[name][trow]               # [n, Hkv, page, Dp]
                    view[name] = jnp.transpose(g, (1, 0, 2, 3)).reshape(
                        1, Hkv, S_view, Dp)
                for name in ("k_scale", "v_scale"):
                    if name in pool:
                        g = pool[name][trow]           # [n, Hkv, 1, page]
                        view[name] = jnp.transpose(g, (1, 2, 0, 3)).reshape(
                            1, Hkv, 1, S_view)
                return view

            def _scatter(pool, view, trow):
                out = dict(pool)
                for name in ("k", "v"):
                    u = view[name].reshape(Hkv, n_ctx_pages, page, Dp)
                    out[name] = pool[name].at[trow].set(
                        jnp.transpose(u, (1, 0, 2, 3)))
                for name in ("k_scale", "v_scale"):
                    if name in pool:
                        u = view[name].reshape(Hkv, 1, n_ctx_pages, page)
                        out[name] = pool[name].at[trow].set(
                            jnp.transpose(u, (2, 0, 1, 3)))
                return out

            def _suffix(params, tokens, chunk_len, cache_len, pools, tables,
                        slot, samp):
                trow = jax.lax.dynamic_slice_in_dim(
                    tables, slot, 1, 0)[0, :n_ctx_pages]
                views = [_gather(pool, trow) for pool in pools]
                logits, new_views = chunk_prefill_step(
                    params, tokens, chunk_len, cache_len, self.cfg_local,
                    views, shim, psum_axis=self._psum_axis,
                )
                new_pools = [_scatter(pool, view, trow)
                             for pool, view in zip(pools, new_views)]
                tok, lp = sample_tokens_with_logprobs(logits[0][None], *samp)
                return (tok[0], lp[0]), new_pools

            fn = _suffix
            if self.tp > 1:
                cspec = jax.tree.map(
                    lambda _: self._cache_spec_leaf, self.pcache.pools)
                fn = jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(self._pspecs, P(), P(), P(), cspec, P(), P(),
                              (P(),) * 5),
                    out_specs=((P(), P()), cspec), check_vma=False,
                )
            self._prefill_cache[key] = jax.jit(fn, donate_argnums=(4,))
        return self._prefill_cache[key]

    def _get_prefill_batch(self, s_pad: int, N: int):
        """Jitted BATCHED prefill: N same-bucket prompts in ONE dispatch
        (one [N, s_pad] forward; per-slot cache writes loop inside the jit).
        One dispatch per N prompts instead of N; compiles are bounded by
        (bucket, N in {2,4}) keys."""
        key = ("batch", s_pad, N)
        if key not in self._prefill_cache:
            if self.paged:
                from fa2_jax.runtime.paged_cache import (
                    write_tokens_paged,
                )

                def _prefill(params, tokens, true_len, pools, tables, slots,
                             samp):
                    logits, kvs = prefill_forward(
                        params, tokens, true_len, self.cfg_local,
                        psum_axis=self._psum_axis,
                    )
                    # One batched scatter per layer: the N slots' table
                    # rows gather to [N, max_pages] and write_tokens_paged
                    # handles B == N directly.
                    trows = jnp.take(tables, slots, axis=0)
                    zeros = jnp.zeros((N,), jnp.int32)
                    new_pools = [
                        write_tokens_paged(pool, trows, k, v, zeros,
                                           self.kv_cfg_local)
                        for pool, (k, v) in zip(pools, kvs)
                    ]
                    rows = jnp.take_along_axis(
                        logits, (true_len - 1)[:, None, None], axis=1)[:, 0]
                    toks, lps = sample_tokens_with_logprobs(rows, *samp)
                    return (toks, lps), new_pools
            else:
                def _prefill(params, tokens, true_len, caches, slots, samp):
                    logits, kvs = prefill_forward(
                        params, tokens, true_len, self.cfg_local,
                        psum_axis=self._psum_axis,
                    )
                    new_caches = caches
                    for i in range(N):
                        upd_caches = []
                        for cache, (k, v) in zip(new_caches, kvs):
                            upd = write_kv(
                                cache_slice(cache, slots[i]),
                                k[i:i + 1], v[i:i + 1],
                                jnp.zeros((1,), jnp.int32),
                                self.kv_cfg_local,
                            )
                            upd_caches.append(
                                cache_write_back(cache, upd, slots[i]))
                        new_caches = upd_caches
                    rows = jnp.take_along_axis(
                        logits, (true_len - 1)[:, None, None], axis=1)[:, 0]
                    toks, lps = sample_tokens_with_logprobs(rows, *samp)
                    return (toks, lps), new_caches

            fn = _prefill
            if self.tp > 1:
                cspec = jax.tree.map(
                    lambda _: self._cache_spec_leaf,
                    self.pcache.pools if self.paged else self.caches,
                )
                in_specs = (
                    (self._pspecs, P(), P(), cspec, P(), P(), (P(),) * 5)
                    if self.paged
                    else (self._pspecs, P(), P(), cspec, P(), (P(),) * 5)
                )
                fn = jax.shard_map(
                    fn, mesh=self.mesh, in_specs=in_specs,
                    out_specs=((P(), P()), cspec), check_vma=False,
                )
            self._prefill_cache[key] = jax.jit(fn, donate_argnums=(3,))
        return self._prefill_cache[key]

    def _get_chunk_prefill(self):
        """Jitted one-chunk prefill (fixed chunk width -> one compile)."""
        if "chunk" not in self._prefill_cache:
            from fa2_jax.models.llama import chunk_prefill_step

            def _chunk(params, tokens, chunk_len, cache_len, caches, slot,
                       samp):
                views = [cache_slice(c, slot) for c in caches]
                logits, new_views = chunk_prefill_step(
                    params, tokens, chunk_len, cache_len, self.cfg_local,
                    views, self.kv_cfg_local, psum_axis=self._psum_axis,
                )
                new_caches = [cache_write_back(c, u, slot)
                              for c, u in zip(caches, new_views)]
                tok, lp = sample_tokens_with_logprobs(logits[0][None], *samp)
                return (tok[0], lp[0]), new_caches

            fn = _chunk
            if self.tp > 1:
                cspec = jax.tree.map(
                    lambda _: self._cache_spec_leaf, self.caches)
                fn = jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(self._pspecs, P(), P(), P(), cspec, P(),
                              (P(),) * 5),
                    out_specs=((P(), P()), cspec), check_vma=False,
                )
            self._prefill_cache["chunk"] = jax.jit(fn, donate_argnums=(4,))
        return self._prefill_cache["chunk"]

    def _step_chunk_prefills(self):
        """Advance every mid-prefill slot by ONE bounded chunk."""
        C = self.prefill_chunk
        for slot in list(self._prefilling):
            req = self.slot_req[slot]
            pos = self._prefilling[slot]
            chunk = req.prompt[pos:pos + C]
            tokens = np.zeros((1, C), np.int32)
            tokens[0, :len(chunk)] = chunk
            if self.paged:
                # Run the chunk through the suffix-prefill program. The view
                # page-count is pow2-bucketed to bound compiles; unallocated
                # table entries gather (and scatter back) the reserved
                # page 0, whose contents the length-clamped attention never
                # reads.
                page = self.kv_cfg.page_size
                while True:
                    try:
                        self.pcache.ensure_capacity(slot, pos + len(chunk))
                        break
                    except MemoryError:
                        victims = [
                            v for v, r in enumerate(self.slot_req)
                            if r is not None and v != slot
                            and v not in self._prefilling
                        ]
                        if not victims:
                            raise
                        self._preempt(max(
                            victims,
                            key=lambda x: len(self.pcache._slot_pages[x])))
                n_pages = min(next_power_of_2(-(-(pos + C) // page)),
                              self.kv_cfg.max_pages_per_slot)
                (next_tok, next_lp), self.pcache.pools = \
                    self._get_suffix_prefill(C, n_pages)(
                        self.params, jnp.asarray(tokens),
                        jnp.asarray([len(chunk)], jnp.int32),
                        jnp.asarray([pos], jnp.int32),
                        self.pcache.pools, self.pcache.tables_device(),
                        slot, self._samp1(req),
                    )
            else:
                (next_tok, next_lp), self.caches = self._get_chunk_prefill()(
                    self.params, jnp.asarray(tokens),
                    jnp.asarray([len(chunk)], jnp.int32),
                    jnp.asarray([pos], jnp.int32), self.caches, slot,
                    self._samp1(req),
                )
            pos += len(chunk)
            self.stats.prefill_tokens += len(chunk)
            if pos >= len(req.prompt):
                # Final chunk: its last-token logits seed decoding.
                del self._prefilling[slot]
                if self.paged and self.prefix_cache:
                    self.pcache.register_prefix(slot, req.prompt)
                self.lens_np[slot] = len(req.prompt)
                self.last_tokens = self.last_tokens.at[slot].set(next_tok)
                req.out_tokens.append(int(next_tok))
                req.out_logprobs.append(float(next_lp))
                self._maybe_finish(slot)
            else:
                self._prefilling[slot] = pos

    # ---------------- scheduling ----------------------------------------

    def _samp1(self, req: Request):
        """Sampling-arg tuple for a single-request (B=1) device call; the
        step counter is the number of tokens already generated (nonzero when
        a preempted request re-prefills its partial generation)."""
        sp = req.sampling
        return (
            jnp.asarray([sp.temperature], jnp.float32),
            jnp.asarray([sp.top_k], jnp.int32),
            jnp.asarray([sp.top_p], jnp.float32),
            jnp.asarray([sp.seed], jnp.uint32),
            jnp.asarray([len(req.out_tokens)], jnp.int32),
        )

    def _samp_batch(self):
        """Per-slot sampling args for the batched decode step."""
        steps = np.zeros((len(self.slot_req),), np.int32)
        for s_, r in enumerate(self.slot_req):
            if r is not None:
                steps[s_] = len(r.out_tokens)
        return (
            jnp.asarray(self.temp_np),
            jnp.asarray(self.topk_np),
            jnp.asarray(self.topp_np),
            jnp.asarray(self.seed_np),
            jnp.asarray(steps),
        )

    def _set_slot_sampling(self, slot: int, req: Request):
        sp = req.sampling
        self.temp_np[slot] = sp.temperature
        self.topk_np[slot] = sp.top_k
        self.topp_np[slot] = sp.top_p
        self.seed_np[slot] = np.uint32(sp.seed)

    def submit(self, prompt: List[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop_ids=None) -> Request:
        req = Request(rid=len(self.queue), prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      sampling=sampling or GREEDY,
                      stop_ids=frozenset(stop_ids) if stop_ids else None)
        self.queue.append(req)
        return req

    def _finish_admission(self, slot: int, req: Request, next_tok, next_lp):
        self.lens_np[slot] = len(req.prompt)
        self.last_tokens = self.last_tokens.at[slot].set(next_tok)
        req.out_tokens.append(int(next_tok))
        req.out_logprobs.append(float(next_lp))
        self.slot_req[slot] = req
        self._set_slot_sampling(slot, req)
        self._maybe_finish(slot)

    def _admit_batch(self, group):
        """One batched prefill dispatch for N same-bucket (slot, req) pairs."""
        s_pad = max(64, next_power_of_2(len(group[0][1].prompt)))
        N = len(group)
        tokens = np.zeros((N, s_pad), np.int32)
        for i, (_, req) in enumerate(group):
            tokens[i, : len(req.prompt)] = req.prompt
        true_len = jnp.asarray([len(r.prompt) for _, r in group], jnp.int32)
        slots = jnp.asarray([s for s, _ in group], jnp.int32)
        samp = (
            jnp.asarray([r.sampling.temperature for _, r in group], jnp.float32),
            jnp.asarray([r.sampling.top_k for _, r in group], jnp.int32),
            jnp.asarray([r.sampling.top_p for _, r in group], jnp.float32),
            jnp.asarray([np.uint32(r.sampling.seed) for _, r in group],
                        jnp.uint32),
            jnp.asarray([len(r.out_tokens) for _, r in group], jnp.int32),
        )
        fn = self._get_prefill_batch(s_pad, N)
        if self.paged:
            (toks, lps), self.pcache.pools = fn(
                self.params, jnp.asarray(tokens), true_len,
                self.pcache.pools, self.pcache.tables_device(), slots, samp)
        else:
            (toks, lps), self.caches = fn(
                self.params, jnp.asarray(tokens), true_len, self.caches,
                slots, samp)
        toks_np, lps_np = np.asarray(toks), np.asarray(lps)
        for i, (slot, req) in enumerate(group):
            self.stats.prefill_tokens += len(req.prompt)
            self._finish_admission(slot, req, toks_np[i], lps_np[i])

    def _admit(self):
        # Same-bucket simple admissions are grouped into ONE batched prefill
        # dispatch (N in {2, 4}); chunked, prefix-cache, and odd-one-out
        # admissions take the single-slot paths. Prefix-cache mode admits
        # sequentially so a request can hit pages registered by the one
        # admitted just before it (same-wave duplicate prompts).
        batchable: List = []
        for slot, occupant in enumerate(self.slot_req):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            if (not self.prefix_cache
                    and (self.prefill_chunk is None
                         or len(req.prompt) <= self.prefill_chunk)):
                s_pad = max(64, next_power_of_2(len(req.prompt)))
                assert s_pad <= self._max_seq_padded, \
                    (len(req.prompt), "prompt exceeds max_seq")
                if self.paged:
                    try:
                        self.pcache.ensure_capacity(slot, s_pad)
                    except MemoryError:
                        self.queue.insert(0, req)
                        break  # flush what we already claimed
                # Reserve the slot now (so this loop doesn't re-offer it);
                # the batch flush fills in the real state.
                self.slot_req[slot] = req
                batchable.append((slot, req))
                continue
            self._admit_one(slot, req)
        # Flush: group by bucket; pairs/quads batch, leftovers go single.
        by_bucket: Dict[int, List] = {}
        for slot, req in batchable:
            by_bucket.setdefault(
                max(64, next_power_of_2(len(req.prompt))), []).append(
                    (slot, req))
        for bucket, group in by_bucket.items():
            while group:
                n = 4 if len(group) >= 4 else (2 if len(group) >= 2 else 1)
                head, group = group[:n], group[n:]
                if n == 1:
                    self._admit_one(*head[0], reserved=True)
                else:
                    self._admit_batch(head)

    def _admit_one(self, slot, req, reserved: bool = False):
        """Admit one request into `slot` (single-dispatch paths:
        chunked claim, prefix-hit suffix prefill, plain prefill).
        `reserved=True` means the admit loop already set
        slot_req/ensured capacity (batch leftovers)."""
        if (self.prefill_chunk is not None
                and len(req.prompt) > self.prefill_chunk):
            # Long prompt: claim the slot now, prefill chunk-by-chunk
            # across subsequent steps (decode keeps running meanwhile).
            assert len(req.prompt) <= self._max_seq_padded
            start = 0
            if self.paged and self.prefix_cache:
                n_cached, shared = self.pcache.match_prefix(req.prompt)
                if n_cached:
                    self.pcache.attach(slot, shared)
                    self.stats.prefix_cached_tokens += n_cached
                    start = n_cached
            self.slot_req[slot] = req
            self._set_slot_sampling(slot, req)
            self._prefilling[slot] = start
            # The batched decode runs over ALL slots every step and
            # writes each slot's new-token KV at its lens — a mid-prefill
            # slot must park its write on the sacrificial tail row (real
            # decodes never write there: requests finish when
            # lens + 1 >= max_seq_padded, and any final chunk covering
            # the tail row rewrites it before this slot re-enters
            # decode). Parking at 0 would corrupt the freshly prefilled
            # row 0 on every interleaved decode step. In PAGED mode the
            # parked position's page is never allocated, so the write
            # routes through table entry 0 — the reserved sacrificial
            # page that nothing ever reads.
            self.lens_np[slot] = self._max_seq_padded - 1
            return
        s_pad = max(64, next_power_of_2(len(req.prompt)))
        assert s_pad <= self._max_seq_padded
        tokens = np.zeros((1, s_pad), np.int32)
        tokens[0, : len(req.prompt)] = req.prompt
        true_len = jnp.asarray([len(req.prompt)], jnp.int32)
        if self.paged:
            n_cached, shared = (
                self.pcache.match_prefix(req.prompt)
                if self.prefix_cache else (0, [])
            )
            if n_cached:
                # Prefix hit: attach the shared pages, prefill only the
                # suffix (its queries attend over the cached prefix).
                suffix = req.prompt[n_cached:]
                c_pad = max(128, next_power_of_2(len(suffix)))
                page = self.kv_cfg.page_size
                if n_cached + c_pad > self._max_seq_padded:
                    c_pad = -(-len(suffix) // 128) * 128
                n_ctx_pages = -(-(n_cached + c_pad) // page)
                self.pcache.attach(slot, shared)
                try:
                    self.pcache.ensure_capacity(slot, n_ctx_pages * page)
                except MemoryError:
                    self.pcache.release(slot)
                    self.queue.insert(0, req)
                    return
                stoks = np.zeros((1, c_pad), np.int32)
                stoks[0, : len(suffix)] = suffix
                (next_tok, next_lp), self.pcache.pools = \
                    self._get_suffix_prefill(c_pad, n_ctx_pages)(
                        self.params, jnp.asarray(stoks),
                        jnp.asarray([len(suffix)], jnp.int32),
                        jnp.asarray([n_cached], jnp.int32),
                        self.pcache.pools, self.pcache.tables_device(),
                        slot, self._samp1(req),
                    )
                self.stats.prefix_cached_tokens += n_cached
                self.stats.prefill_tokens += len(suffix)
            else:
                try:
                    self.pcache.ensure_capacity(slot, s_pad)
                except MemoryError:
                    self.queue.insert(0, req)  # retry when pages free up
                    return
                (next_tok, next_lp), self.pcache.pools = \
                    self._get_prefill(s_pad)(
                        self.params, jnp.asarray(tokens), true_len,
                        self.pcache.pools, self.pcache.tables_device(),
                        slot, self._samp1(req),
                    )
                self.stats.prefill_tokens += len(req.prompt)
            if self.prefix_cache:
                self.pcache.register_prefix(slot, req.prompt)
        else:
            (next_tok, next_lp), self.caches = self._get_prefill(s_pad)(
                self.params, jnp.asarray(tokens), true_len, self.caches,
                slot, self._samp1(req),
            )
            self.stats.prefill_tokens += len(req.prompt)
        self.lens_np[slot] = len(req.prompt)
        self.last_tokens = self.last_tokens.at[slot].set(next_tok)
        req.out_tokens.append(int(next_tok))
        req.out_logprobs.append(float(next_lp))
        self.slot_req[slot] = req
        self._set_slot_sampling(slot, req)
        self._maybe_finish(slot)

    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        tok = req.out_tokens[-1] if req.out_tokens else None
        exhausted = len(req.out_tokens) >= req.max_new_tokens
        full = int(self.lens_np[slot]) + 1 >= self._max_seq_padded
        stopped = ((self.eos_id is not None and tok == self.eos_id)
                   or (req.stop_ids is not None and tok in req.stop_ids))
        if stopped or exhausted or full:
            req.done = True
            self.slot_req[slot] = None
            if self.paged:
                if self.prefix_cache:
                    # Publish the GENERATED tokens' full pages too, so a
                    # follow-up turn (prompt2 = prompt + generation + more)
                    # reuses them. The last sampled token was never fed back,
                    # so its KV was never written — exclude it.
                    new = req.out_tokens[req.folded:]
                    seq = list(req.prompt) + new[:-1]
                    self.pcache.register_prefix(slot, seq)
                # Finished sequences return their pages to the shared pool.
                self.pcache.release(slot)

    def _preempt(self, slot: int):
        """Evict an in-flight request from its slot (paged mode): its pages
        return to the pool, and it re-enters the queue with generated tokens
        folded into the prompt, so it later resumes exactly where it was."""
        req = self.slot_req[slot]
        req.prompt = list(req.prompt) + [int(t) for t in req.out_tokens[req.folded:]]
        req.folded = len(req.out_tokens)
        # out_tokens are kept: 'exhausted' accounting and the user-visible
        # generation stay correct; the re-prefill continues from the last
        # generated token.
        self.slot_req[slot] = None
        self.pcache.release(slot)
        self.queue.insert(0, req)

    def step(self):
        """One engine iteration: admit waiting requests, advance mid-prefill
        slots by one bounded chunk, then decode all active slots by one
        token."""
        self._admit()
        if self._prefilling:
            self._step_chunk_prefills()
        active = [s for s, r in enumerate(self.slot_req)
                  if r is not None and s not in self._prefilling]
        if not active:
            return bool(self._prefilling)
        if self.paged:
            # Sliding-window models (ALL layers windowed): pages entirely
            # behind the window are dead — the decode kernel's first-block
            # clamp never reads them — so return them to the pool while the
            # sequence keeps generating (the paged form of Mistral's rolling
            # buffer: live KV memory is O(window), not O(sequence)).
            w = self.cfg.sliding_window
            if w >= 0 and not self.cfg.alt_window:
                page = self.kv_cfg.page_size
                for s in active:
                    behind = int(self.lens_np[s]) - w
                    if behind > 0:
                        self.pcache.release_prefix(s, behind // page)
            for s in list(active):
                if self.slot_req[s] is None:  # preempted earlier this step
                    continue
                while True:
                    try:
                        self.pcache.ensure_capacity(s, int(self.lens_np[s]) + 1)
                        break
                    except MemoryError:
                        # Pool exhausted mid-generation: preempt another
                        # active sequence (vLLM-style) — requeue it with its
                        # progress folded into the prompt (decode is
                        # deterministic — greedy, and sampled tokens come
                        # from a per-(seed, position) counter stream — so it
                        # resumes identically), release its pages, retry.
                        victims = [v for v in active if v != s
                                   and self.slot_req[v] is not None]
                        if not victims:
                            raise  # nothing left to preempt
                        v = max(victims,
                                key=lambda x: len(self.pcache._slot_pages[x]))
                        self._preempt(v)
            active = [s for s in active if self.slot_req[s] is not None]
            if not active:
                return bool(self.queue)
            decode = (self._decode_greedy
                      if all(self.temp_np[s] <= 0.0 for s in active)
                      else self._decode)
            lens_dev = jnp.asarray(self.lens_np)
            (next_tokens, next_lps), self.pcache.pools = decode(
                self.params, self.last_tokens, self.pcache.pools,
                self.pcache.tables_device(), lens_dev, self._samp_batch()
            )
        else:
            decode = (self._decode_greedy
                      if all(self.temp_np[s] <= 0.0 for s in active)
                      else self._decode)
            lens_dev = jnp.asarray(self.lens_np)
            (next_tokens, next_lps), self.caches = decode(
                self.params, self.last_tokens, self.caches, lens_dev,
                self._samp_batch()
            )
        # The ONLY per-step device read: the freshly generated tokens (+
        # their logprobs, same transfer).
        next_np = np.asarray(next_tokens)
        lps_np = np.asarray(next_lps)
        active_mask = jnp.asarray(
            [self.slot_req[s] is not None for s in range(len(self.slot_req))]
        )
        # Feed each slot's freshly generated token into the next step.
        self.last_tokens = jnp.where(active_mask, next_tokens, self.last_tokens)
        for s in active:
            self.lens_np[s] += 1
        for s in active:
            self.slot_req[s].out_tokens.append(int(next_np[s]))
            self.slot_req[s].out_logprobs.append(float(lps_np[s]))
            self.stats.decode_tokens += 1
            self._maybe_finish(s)
        self.stats.decode_steps += 1
        return True

    def run(self, requests: List[Request] | None = None) -> EngineStats:
        """Drain the queue (plus any given requests) to completion."""
        if requests:
            self.queue.extend(requests)
        t0 = time.perf_counter()
        while self.queue or any(r is not None for r in self.slot_req):
            progressed = self.step()
            if not progressed and not self.queue:
                break
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats


class DataParallelEngine:
    """Serving across the mesh's `data` axis: one independent TP `Engine`
    per data slice (its own slot pool, KV caches, and jitted step over its
    `model`-axis submesh) fed from a SHARED request queue by free capacity.

    This is the measurable shape of BASELINE's ">= 80% tokens/s scaling
    1 -> 2 hosts": replicas share no device state, so aggregate decode
    throughput scales with the data-axis size; on real multi-host meshes
    each host drives its own slice (`parallel/mesh.py:make_multihost_mesh`
    puts `data` across hosts and `model` within a host). Token
    parity vs a single engine is pinned by `tests/test_serving_tp.py`.
    """

    def __init__(self, params, cfg: LlamaConfig, mesh: Mesh,
                 n_slots: int = 8, max_seq: int = 2048, **engine_kw):
        from fa2_jax.parallel.mesh import AXIS_DATA, AXIS_MODEL

        d = int(mesh.shape.get(AXIS_DATA, 1))
        m = int(mesh.shape.get(AXIS_MODEL, 1))
        extra = 1
        for name, size in mesh.shape.items():
            if name not in (AXIS_DATA, AXIS_MODEL):
                extra *= size
        assert extra == 1, "serving mesh must only have data/model axes"
        devs = mesh.devices.reshape(d, m)
        self.engines = []
        for i in range(d):
            sub = Mesh(devs[i], (AXIS_MODEL,)) if m > 1 else None
            self.engines.append(Engine(
                params, cfg, n_slots=n_slots, max_seq=max_seq, mesh=sub,
                **engine_kw))
        self.queue: List[Request] = []
        self._rid = 0

    def submit(self, prompt: List[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop_ids=None) -> Request:
        req = Request(rid=self._rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      sampling=sampling or GREEDY,
                      stop_ids=frozenset(stop_ids) if stop_ids else None)
        self._rid += 1
        self.queue.append(req)
        return req

    def _dispatch(self):
        """Feed the shared queue to the replica with the most free capacity."""
        while self.queue:
            free = [
                (sum(r is None for r in e.slot_req) - len(e.queue), i)
                for i, e in enumerate(self.engines)
            ]
            best_free, best = max(free)
            if best_free <= 0:
                return
            self.engines[best].queue.append(self.queue.pop(0))

    def step(self) -> bool:
        self._dispatch()
        progressed = [e.step() for e in self.engines]
        return any(progressed)

    def run(self, requests: List[Request] | None = None) -> EngineStats:
        if requests:
            self.queue.extend(requests)
        t0 = time.perf_counter()
        while (self.queue
               or any(e.queue or any(r is not None for r in e.slot_req)
                      for e in self.engines)):
            if not self.step() and not self.queue:
                break
        agg = EngineStats(wall_s=time.perf_counter() - t0)
        for e in self.engines:
            agg.prefill_tokens += e.stats.prefill_tokens
            agg.decode_tokens += e.stats.decode_tokens
            agg.prefix_cached_tokens += e.stats.prefix_cached_tokens
            agg.decode_steps = max(agg.decode_steps, e.stats.decode_steps)
        return agg


# -------- slot slicing helpers (single-slot cache views) -----------------

def cache_slice(cache: dict, slot: int) -> dict:
    return {k: jax.lax.dynamic_slice_in_dim(v, slot, 1, axis=0)
            for k, v in cache.items()}


def cache_write_back(cache: dict, upd: dict, slot: int) -> dict:
    return {k: jax.lax.dynamic_update_slice_in_dim(cache[k], upd[k], slot, axis=0)
            for k in cache}
