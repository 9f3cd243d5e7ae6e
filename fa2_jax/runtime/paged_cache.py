"""Paged KV-cache pool with block tables (vLLM-style) for serving.

Where `runtime/kv_cache.py` reserves max_seq per slot, the paged pool shares
physical pages among sequences: a slot holds only the pages its live tokens
need, so total cache memory scales with live tokens, not slots x max_seq.
The decode side is `ops/decode.py:paged_decode_attention` — each program
reads its own block-table row and loads only live pages.

Page allocation is HOST control logic (free list + per-slot tables, mirrored
to a device array when they change); token writes are device scatters.

Automatic prefix caching (vLLM-style): full pages are content-addressed by a
chain hash over their token ids, refcounted, and shared copy-on-nothing —
shared pages are immutable by construction, because a slot only ever writes
at positions >= its attached-prefix length. Finished sequences' pages stay
resident (LRU) until the allocator needs them, so a later request with the
same prompt prefix skips recomputing those pages' KV entirely.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax.ops.quant import quantize_tensor
from fa2_jax.utils import head_dim_padded


@dataclass(frozen=True)
class PagedCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int                   # model head dim (pre-padding)
    page_size: int = 512            # tokens per page (power of two, >= 16)
    n_pages: int = 64               # physical pages in the shared pool
    n_slots: int = 8
    max_seq: int = 8192
    qdtype: Optional[Any] = None
    compute_dtype: Any = jnp.bfloat16

    @property
    def head_dim_padded(self) -> int:
        return head_dim_padded(self.head_dim)

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


class PagedKVCache:
    """Shared page pool + per-slot block tables + free-list allocator."""

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        shape = (cfg.n_pages, cfg.n_kv_heads, cfg.page_size, cfg.head_dim_padded)
        sshape = (cfg.n_pages, cfg.n_kv_heads, 1, cfg.page_size)
        vdtype = cfg.qdtype if cfg.qdtype is not None else cfg.compute_dtype
        self.pools: List[dict] = []
        for _ in range(cfg.n_layers):
            layer = {"k": jnp.zeros(shape, vdtype), "v": jnp.zeros(shape, vdtype)}
            if cfg.qdtype is not None:
                layer["k_scale"] = jnp.ones(sshape, jnp.float32)
                layer["v_scale"] = jnp.ones(sshape, jnp.float32)
            self.pools.append(layer)
        # Host-side control state. Page 0 is reserved as the clamp target for
        # unallocated table entries (never handed out).
        self._free: List[int] = list(range(cfg.n_pages - 1, 0, -1))
        self._tables = np.zeros((cfg.n_slots, cfg.max_pages_per_slot), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(cfg.n_slots)]
        # Leading logical pages already released behind a sliding window
        # (`release_prefix`): logical page i >= _slot_freed[slot] lives at
        # _slot_pages[i - _slot_freed[slot]].
        self._slot_freed: List[int] = [0] * cfg.n_slots
        self._tables_dev: Optional[jax.Array] = None
        # Prefix-cache state: per-page refcounts; chain-hash -> page for full
        # registered pages; page -> chain-hash (for eviction unregister); and
        # the LRU set of ref-0 pages whose contents are still valid/reusable.
        self._refs = np.zeros((cfg.n_pages,), np.int32)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()

    # ------------------------- host allocation ---------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._cached_free)

    def tables_device(self) -> jax.Array:
        if self._tables_dev is None:
            self._tables_dev = jnp.asarray(self._tables)
        return self._tables_dev

    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        # Evict the least-recently-used prefix-cached page: its contents are
        # reusable but nothing references it, so it can be repurposed.
        if self._cached_free:
            page, _ = self._cached_free.popitem(last=False)
            h = self._page_hash.pop(page)
            del self._hash_to_page[h]
            return page
        raise MemoryError("KV page pool exhausted")

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Allocate pages so `slot` can hold n_tokens; raises if pool full."""
        need = -(-n_tokens // self.cfg.page_size)
        assert need <= self.cfg.max_pages_per_slot, (n_tokens, "exceeds max_seq")
        pages = self._slot_pages[slot]
        freed = self._slot_freed[slot]
        while freed + len(pages) < need:
            page = self._alloc_page()
            self._refs[page] = 1
            self._tables[slot, freed + len(pages)] = page
            pages.append(page)
            self._tables_dev = None

    def release(self, slot: int) -> None:
        """Drop the slot's references; unshared unregistered pages return to
        the free list, registered ones stay resident as prefix-cache LRU."""
        for page in reversed(self._slot_pages[slot]):
            self._refs[page] -= 1
            if self._refs[page] == 0:
                if page in self._page_hash:
                    self._cached_free[page] = None
                else:
                    self._free.append(page)
        self._slot_pages[slot] = []
        self._slot_freed[slot] = 0
        self._tables[slot] = 0
        self._tables_dev = None

    def release_prefix(self, slot: int, n_logical_pages: int) -> None:
        """Release the slot's leading logical pages (sliding-window serving:
        pages entirely behind the window are never read again — the decode
        kernels clamp their first block to the window — so their memory
        returns to the pool while the sequence keeps generating). Their
        table entries point at the reserved page 0 afterwards. Registered
        (prefix-cache) pages stay resident via the usual ref-0 LRU path."""
        freed = self._slot_freed[slot]
        drop = n_logical_pages - freed
        if drop <= 0:
            return
        assert drop <= len(self._slot_pages[slot])
        for i, page in enumerate(self._slot_pages[slot][:drop]):
            self._refs[page] -= 1
            if self._refs[page] == 0:
                if page in self._page_hash:
                    self._cached_free[page] = None
                else:
                    self._free.append(page)
            self._tables[slot, freed + i] = 0
        self._slot_pages[slot] = self._slot_pages[slot][drop:]
        self._slot_freed[slot] = n_logical_pages
        self._tables_dev = None

    # ------------------------- prefix caching ----------------------------

    @staticmethod
    def _chunk_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
        return hashlib.blake2b(
            prev + np.asarray(tokens, np.int32).tobytes(), digest_size=16
        ).digest()

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest registered full-page prefix of `tokens` -> (n_tokens,
        pages). Capped at len(tokens)-1 so at least one token remains to
        prefill (logits for the first generated token must be computed)."""
        P = self.cfg.page_size
        pages: List[int] = []
        h = b""
        for i in range((len(tokens) - 1) // P):
            h = self._chunk_hash(h, tokens[i * P:(i + 1) * P])
            page = self._hash_to_page.get(h)
            if page is None:
                break
            pages.append(page)
        return len(pages) * P, pages

    def attach(self, slot: int, pages: Sequence[int]) -> None:
        """Point an EMPTY slot's table at shared prefix pages (refcounted).
        The slot must only write at positions >= len(pages)*page_size, which
        the engine guarantees: its suffix prefill starts exactly there."""
        assert not self._slot_pages[slot] and not self._slot_freed[slot], \
            "attach requires an empty slot"
        for i, page in enumerate(pages):
            self._tables[slot, i] = page
            self._refs[page] += 1
            self._cached_free.pop(page, None)  # referenced again: not evictable
        self._slot_pages[slot] = list(pages)
        self._tables_dev = None

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> None:
        """After `slot` holds valid KV for `tokens[0:len(tokens))`, publish
        its full pages into the prefix cache (first writer wins per hash)."""
        P = self.cfg.page_size
        freed = self._slot_freed[slot]
        h = b""
        for i in range(len(tokens) // P):
            h = self._chunk_hash(h, tokens[i * P:(i + 1) * P])
            if i < freed:  # window-released page: keep hashing, can't publish
                continue
            page = self._slot_pages[slot][i - freed]
            if h not in self._hash_to_page and page not in self._page_hash:
                self._hash_to_page[h] = page
                self._page_hash[page] = h

    # ------------------------- device writes -----------------------------

    def write_tokens(
        self,
        layer_idx: int,
        new_k: jax.Array,     # [B, S_step, Hkv, D] — B == n_slots
        new_v: jax.Array,
        positions: jax.Array,  # [B] int32 — first token's seq position per slot
    ) -> None:
        """Scatter S_step new tokens per slot into the shared pool. Callers
        must have `ensure_capacity(slot, position + S_step)` first."""
        self.pools[layer_idx] = write_tokens_paged(
            self.pools[layer_idx], self.tables_device(), new_k, new_v,
            positions, self.cfg,
        )

    # ------------------------- decode read -------------------------------

    def attention(self, layer_idx: int, q: jax.Array, kv_lens: jax.Array,
                  softmax_scale: Optional[float] = None) -> jax.Array:
        """Paged decode attention for one layer; q [B, Hq, D] (padded D)."""
        from fa2_jax.ops.decode import paged_decode_attention

        pool = self.pools[layer_idx]
        return paged_decode_attention(
            q, pool["k"], pool["v"], self.tables_device(), kv_lens,
            pool.get("k_scale"), pool.get("v_scale"),
            softmax_scale=softmax_scale,
        )


def write_tokens_paged(
    pool: dict,
    tables: jax.Array,     # [n_slots, max_pages] int32
    new_k: jax.Array,      # [B, S_step, Hkv, D] — B == n_slots
    new_v: jax.Array,
    positions: jax.Array,  # [B] int32 — first token's seq position per slot
    cfg: PagedCacheConfig,
) -> dict:
    """Pure scatter of S_step new tokens per slot into the shared page pool
    (jit-friendly: pools/tables in, new pools out)."""
    B, S_step, Hkv, D = new_k.shape
    kT = jnp.transpose(new_k.astype(cfg.compute_dtype), (0, 2, 1, 3))
    vT = jnp.transpose(new_v.astype(cfg.compute_dtype), (0, 2, 1, 3))
    pad = cfg.head_dim_padded - D
    if pad:
        kT = jnp.pad(kT, ((0, 0), (0, 0), (0, 0), (0, pad)))
        vT = jnp.pad(vT, ((0, 0), (0, 0), (0, 0), (0, pad)))

    pos = positions[:, None] + jnp.arange(S_step, dtype=jnp.int32)[None, :]
    pages = jnp.take_along_axis(tables, pos // cfg.page_size, axis=1)  # [B, S]
    offs = pos % cfg.page_size

    out = dict(pool)
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    p_f, o_f = pages.reshape(-1), offs.reshape(-1)
    # [B, H, S, Dp] -> token-major [B*S, H, Dp] for the scatter.
    k_tok = flat(jnp.transpose(kT, (0, 2, 1, 3)))
    v_tok = flat(jnp.transpose(vT, (0, 2, 1, 3)))
    if cfg.qdtype is not None:
        kq, ks = quantize_tensor(k_tok, cfg.qdtype)   # [N, H, Dp], [N, H, 1]
        vq, vs = quantize_tensor(v_tok, cfg.qdtype)
        out["k"] = pool["k"].at[p_f, :, o_f, :].set(kq)
        out["v"] = pool["v"].at[p_f, :, o_f, :].set(vq)
        out["k_scale"] = pool["k_scale"].at[p_f, :, 0, o_f].set(ks[..., 0])
        out["v_scale"] = pool["v_scale"].at[p_f, :, 0, o_f].set(vs[..., 0])
    else:
        out["k"] = pool["k"].at[p_f, :, o_f, :].set(k_tok)
        out["v"] = pool["v"].at[p_f, :, o_f, :].set(v_tok)
    return out
