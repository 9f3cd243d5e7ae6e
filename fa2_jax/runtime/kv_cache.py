"""Paged-per-slot KV cache store (optionally quantized) for serving.

Caches live in the decode kernel's native layout [slots, Hkv, S_max, Dp]
(BHSD, seq padded to the decode block, head dim padded to a power of two) so
decode steps never transpose or pad. Values are stored bf16 or quantized
(int8/fp8_e4m3) with per-(token, head) scales; quantization happens at
insert time, dequant happens inside the attention kernels (`ops/decode.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp

from fa2_jax.ops.quant import quantize_tensor
from fa2_jax.utils import head_dim_padded, round_up_to_multiple


@dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int                 # model head dim (pre-padding)
    max_seq: int
    n_slots: int
    qdtype: Optional[Any] = None  # None (bf16), jnp.int8, or jnp.float8_e4m3fn
    compute_dtype: Any = jnp.bfloat16
    block_kv: int = 128

    @property
    def head_dim_padded(self) -> int:
        return head_dim_padded(self.head_dim)

    @property
    def max_seq_padded(self) -> int:
        # Pad to the largest kernel block; the decode kernel shrinks its
        # block to a divisor of the cache extent.
        return round_up_to_multiple(self.max_seq, 128)


def init_cache(cfg: KVCacheConfig) -> List[dict]:
    """One dict per layer: k, v [S, H, T, D] (+ k_scale, v_scale if quantized)."""
    shape = (cfg.n_slots, cfg.n_kv_heads, cfg.max_seq_padded, cfg.head_dim_padded)
    # Scales transposed — [slots, H, 1, S] — the decode kernel's layout (a
    # block's scales are one contiguous row; see ops/decode.py).
    sshape = (cfg.n_slots, cfg.n_kv_heads, 1, cfg.max_seq_padded)
    vdtype = cfg.qdtype if cfg.qdtype is not None else cfg.compute_dtype
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "k": jnp.zeros(shape, vdtype),
            "v": jnp.zeros(shape, vdtype),
        }
        if cfg.qdtype is not None:
            layer["k_scale"] = jnp.ones(sshape, jnp.float32)
            layer["v_scale"] = jnp.ones(sshape, jnp.float32)
        layers.append(layer)
    return layers


def _to_cache_layout(x: jax.Array, cfg: KVCacheConfig) -> jax.Array:
    """[B, S, H, D] -> [B, H, S, Dp] (pad head dim)."""
    x = jnp.transpose(x, (0, 2, 1, 3))
    pad = cfg.head_dim_padded - x.shape[-1]
    if pad:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, pad)))
    return x


def write_kv(
    layer_cache: dict,
    new_k: jax.Array,    # [B, S_step, Hkv, D] — B must equal n_slots here
    new_v: jax.Array,
    offsets: jax.Array,  # [B] int32 — write position per slot
    cfg: KVCacheConfig,
) -> dict:
    """Insert (quantizing if configured) at per-slot offsets."""
    kT = _to_cache_layout(new_k.astype(cfg.compute_dtype), cfg)
    vT = _to_cache_layout(new_v.astype(cfg.compute_dtype), cfg)
    out = dict(layer_cache)
    if cfg.qdtype is not None:
        kq, ks = quantize_tensor(kT, cfg.qdtype)
        vq, vs = quantize_tensor(vT, cfg.qdtype)
        ks = jnp.swapaxes(ks, 2, 3)   # [B, H, S, 1] -> [B, H, 1, S]
        vs = jnp.swapaxes(vs, 2, 3)

        def upd(cache, val, off):
            return jax.lax.dynamic_update_slice(cache, val, (0, off, 0))

        def upd_scale(cache, val, off):
            return jax.lax.dynamic_update_slice(cache, val, (0, 0, off))

        out["k"] = jax.vmap(upd)(layer_cache["k"], kq, offsets)
        out["v"] = jax.vmap(upd)(layer_cache["v"], vq, offsets)
        out["k_scale"] = jax.vmap(upd_scale)(layer_cache["k_scale"], ks, offsets)
        out["v_scale"] = jax.vmap(upd_scale)(layer_cache["v_scale"], vs, offsets)
    else:
        def upd(cache, val, off):
            return jax.lax.dynamic_update_slice(cache, val, (0, off, 0))

        out["k"] = jax.vmap(upd)(layer_cache["k"], kT, offsets)
        out["v"] = jax.vmap(upd)(layer_cache["v"], vT, offsets)
    return out
