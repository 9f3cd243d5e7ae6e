"""GPT-2-style decoder LM on the flash-attention kernels.

Second model family (the reference is a kernel library with no model layer;
this demonstrates the kernels under a different architecture from
`models/llama.py`): LayerNorm (with bias) + learned absolute position
embeddings + MHA (n_kv_heads == n_heads) + GELU MLP + tied or untied head,
pre-norm residual wiring. Pure functions over a parameter pytree, like the
LLaMA slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from fa2_jax.ops import flash_attn_func
from fa2_jax.ops.attention import flash_attn_with_kv_cache
from fa2_jax.ops.quant import qmatmul as _mm


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: Any = jnp.bfloat16
    tie_embeddings: bool = True

    @property
    def hd(self) -> int:
        return self.dim // self.n_heads


Params = Dict[str, Any]


def _dense(key, shape, fan_in, dtype):
    w = jax.random.normal(key, shape, jnp.float32) / math.sqrt(fan_in)
    return w.astype(dtype)


def init_params(key: jax.Array, cfg: GPT2Config) -> Params:
    keys = jax.random.split(key, cfg.n_layers + 3)
    layers = []
    for li in range(cfg.n_layers):
        k = jax.random.split(keys[li], 4)
        layers.append({
            "ln1_g": jnp.ones((cfg.dim,), jnp.float32),
            "ln1_b": jnp.zeros((cfg.dim,), jnp.float32),
            # Fused qkv projection, GPT-2 style.
            "w_qkv": _dense(k[0], (cfg.dim, 3 * cfg.dim), cfg.dim, cfg.dtype),
            "b_qkv": jnp.zeros((3 * cfg.dim,), jnp.float32),
            "w_proj": _dense(k[1], (cfg.dim, cfg.dim), cfg.dim, cfg.dtype),
            "b_proj": jnp.zeros((cfg.dim,), jnp.float32),
            "ln2_g": jnp.ones((cfg.dim,), jnp.float32),
            "ln2_b": jnp.zeros((cfg.dim,), jnp.float32),
            "w_fc": _dense(k[2], (cfg.dim, cfg.hidden_dim), cfg.dim, cfg.dtype),
            "b_fc": jnp.zeros((cfg.hidden_dim,), jnp.float32),
            "w_out": _dense(k[3], (cfg.hidden_dim, cfg.dim), cfg.hidden_dim, cfg.dtype),
            "b_out": jnp.zeros((cfg.dim,), jnp.float32),
        })
    params = {
        "wte": _dense(keys[-3], (cfg.vocab_size, cfg.dim), cfg.dim, cfg.dtype),
        "wpe": _dense(keys[-2], (cfg.max_seq_len, cfg.dim), cfg.dim, cfg.dtype),
        "layers": layers,
        "lnf_g": jnp.ones((cfg.dim,), jnp.float32),
        "lnf_b": jnp.zeros((cfg.dim,), jnp.float32),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(
            keys[-1], (cfg.dim, cfg.vocab_size), cfg.dim, cfg.dtype)
    return params


def layer_norm(x, g, b, eps):
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean((xf - mu) ** 2, axis=-1, keepdims=True)
    return ((xf - mu) * jax.lax.rsqrt(var + eps) * g + b).astype(x.dtype)


def _block(layer: Params, x: jax.Array, cfg: GPT2Config,
           cache=None, cache_len=None):
    B, S, _ = x.shape
    h = layer_norm(x, layer["ln1_g"], layer["ln1_b"], cfg.norm_eps)
    qkv = _mm(h, layer["w_qkv"]) + layer["b_qkv"].astype(x.dtype)
    q, k, v = jnp.split(qkv, 3, axis=-1)
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_heads, cfg.hd)
    new_cache = None
    if cache is not None:
        ck, cv = cache
        ck = jax.lax.dynamic_update_slice(ck, k, (0, cache_len, 0, 0))
        cv = jax.lax.dynamic_update_slice(cv, v, (0, cache_len, 0, 0))
        new_cache = (ck, cv)
        attn = flash_attn_with_kv_cache(q, ck, cv, cache_len + S)
    else:
        attn = flash_attn_func(q, k, v, causal=True)
    a = _mm(attn.reshape(B, S, cfg.dim), layer["w_proj"])
    x = x + a + layer["b_proj"].astype(x.dtype)
    h = layer_norm(x, layer["ln2_g"], layer["ln2_b"], cfg.norm_eps)
    m = jax.nn.gelu(_mm(h, layer["w_fc"]) + layer["b_fc"].astype(x.dtype))
    x = x + _mm(m, layer["w_out"]) + layer["b_out"].astype(x.dtype)
    return x, new_cache


def forward(params: Params, tokens: jax.Array, cfg: GPT2Config,
            positions: Optional[jax.Array] = None) -> jax.Array:
    """Training forward -> logits [B, S, vocab] fp32."""
    B, S = tokens.shape
    if positions is None:
        positions = jnp.arange(S, dtype=jnp.int32)
    x = params["wte"][tokens] + params["wpe"][positions]
    for layer in params["layers"]:
        x, _ = _block(layer, x, cfg)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        return (x @ params["wte"].T).astype(jnp.float32)
    return _mm(x, head).astype(jnp.float32)


def loss_fn(params: Params, tokens: jax.Array, cfg: GPT2Config) -> jax.Array:
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int):
    return [
        (
            jnp.zeros((batch, max_len, cfg.n_heads, cfg.hd), cfg.dtype),
            jnp.zeros((batch, max_len, cfg.n_heads, cfg.hd), cfg.dtype),
        )
        for _ in range(cfg.n_layers)
    ]


def forward_with_cache(params: Params, tokens: jax.Array, cfg: GPT2Config,
                       caches, cache_len: jax.Array):
    """One prefill/decode step -> (logits [B, S_step, V], new caches)."""
    B, S = tokens.shape
    positions = cache_len + jnp.arange(S, dtype=jnp.int32)
    x = params["wte"][tokens] + params["wpe"][positions]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        x, nc = _block(layer, x, cfg, cache=cache, cache_len=cache_len)
        new_caches.append(nc)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.norm_eps)
    head = params.get("lm_head")
    logits = (x @ params["wte"].T if head is None else _mm(x, head))
    return logits.astype(jnp.float32), new_caches
