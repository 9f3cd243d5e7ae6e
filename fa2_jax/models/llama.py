"""LLaMA-style decoder LM built on the flash-attention kernels.

The reference is a kernel library with no model layer; this is the
"minimum end-to-end slice" of SURVEY.md §7 step 5 (and the flagship model
for serving/scale-out): RMSNorm + RoPE + GQA flash attention + SwiGLU,
implemented as pure functions over a parameter pytree — idiomatic JAX
(no framework dependency), trivially shardable with jax.sharding.

Layout convention: activations [batch, seq, dim]; attention tensors BSHD
(the `flash_attn_func` public layout).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from fa2_jax.ops import flash_attn_func
from fa2_jax.ops.quant import qmatmul as _mm, quantize_weight


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 4
    hidden_dim: int = 5632          # SwiGLU inner dim
    head_dim: Optional[int] = None  # defaults to dim // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: Any = jnp.bfloat16
    # Mistral-style sliding-window attention: each token attends to at most
    # `window` previous tokens ((-1, 0) = full causal). Uses the kernels'
    # native window support (`ops/flash_fwd.py`), a feature the reference
    # only has in its oracle (`reference_implementation.py:8-35`).
    sliding_window: int = -1
    # Qwen2-style additive q/k/v projection biases (stored as layer keys
    # "bq"/"bk"/"bv"; HF-converted checkpoints carry them regardless of this
    # flag — it only controls from-scratch init).
    qkv_bias: bool = False
    # Gemma-style knobs: MLP activation ("silu" SwiGLU, or "gelu_tanh"
    # GeGLU), final-logit tanh softcapping (0 = off; the ATTENTION softcap is
    # a kernel feature, `flash_attn_func(softcap=...)`), and an activation
    # scale on the token embeddings (Gemma multiplies by sqrt(dim) WITHOUT
    # scaling the tied lm_head; conversion absorbs it into params["embed"],
    # so no config field is needed for it).
    hidden_act: str = "silu"
    logit_softcap: float = 0.0
    # Gemma2-style attention knobs: tanh score capping inside every
    # attention call (the kernels' native `softcap`), an explicit softmax
    # scale (query_pre_attn_scalar**-0.5; None = 1/sqrt(head_dim)), and
    # layer-ALTERNATING sliding windows (even layers use `sliding_window`,
    # odd layers full causal — HF Gemma2's `not bool(layer_idx % 2)` rule).
    # Post-norms (RMSNorm on each sublayer's OUTPUT before the residual add)
    # are presence-driven: layers carrying "post_attn_norm"/"post_mlp_norm"
    # keys apply them, so the config needs no flag.
    attn_softcap: float = 0.0
    attn_scale: Optional[float] = None
    alt_window: bool = False
    # Fully general per-layer windowing (True = that layer slides): takes
    # precedence over alt_window. Qwen2's max_window_layers maps here (the
    # FIRST max_window_layers layers are full attention in HF).
    window_pattern: Optional[Tuple[bool, ...]] = None
    # Llama-3.x RoPE frequency scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings), applied to
    # inv_freq exactly as HF's `_compute_llama3_parameters`. None = vanilla
    # RoPE. A tuple (not the HF dict) keeps the frozen config hashable.
    rope_factors: Optional[Tuple[float, float, float, float]] = None
    # Gradient checkpointing: rematerialize each transformer layer in the
    # backward pass instead of saving its activations — the HBM-for-FLOPs
    # trade that lets long-sequence training fit (the flash kernels already
    # recompute attention probabilities from the LSE; this extends the same
    # policy to the whole layer).
    remat: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def scale(self) -> float:
        return (self.attn_scale if self.attn_scale is not None
                else self.hd ** -0.5)

    def window_for(self, li: int) -> int:
        """Effective sliding window for layer `li` (-1 = full causal)."""
        if self.sliding_window < 0:
            return -1
        if self.window_pattern is not None:
            return self.sliding_window if self.window_pattern[li] else -1
        if self.alt_window and li % 2 == 1:
            return -1
        return self.sliding_window

    @property
    def uniform_window(self) -> bool:
        """True when every layer has the same window (scan-able layers)."""
        return (self.window_pattern is None and not self.alt_window) or \
            len({self.window_for(i) for i in range(self.n_layers)}) == 1


Params = Dict[str, Any]


def llama31_8b(n_layers: int = 32, dtype: Any = jnp.bfloat16) -> LlamaConfig:
    """Llama-3.1-8B at its published widths (HF `config.json`: hidden 4096,
    32 heads, 8 KV heads, head_dim 128, SwiGLU 14336, vocab 128256,
    rope_theta 5e5 with llama3 scaling (8, 1, 4, 8192), rms eps 1e-5,
    untied lm_head). `n_layers` cuts the depth only."""
    return LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, hidden_dim=14336, rope_theta=500000.0, norm_eps=1e-5,
        max_seq_len=131072, rope_factors=(8.0, 1.0, 4.0, 8192),
        dtype=dtype,
    )




def _dense_init(key, shape, in_axis_size, dtype):
    return (jax.random.normal(key, shape, jnp.float32) / math.sqrt(in_axis_size)).astype(dtype)


def init_params(key: jax.Array, cfg: LlamaConfig) -> Params:
    keys = jax.random.split(key, cfg.n_layers + 2)
    layers = []
    for li in range(cfg.n_layers):
        k = jax.random.split(keys[li], 7)
        bias = {
            "bq": jnp.zeros((cfg.n_heads * cfg.hd,), jnp.float32),
            "bk": jnp.zeros((cfg.n_kv_heads * cfg.hd,), jnp.float32),
            "bv": jnp.zeros((cfg.n_kv_heads * cfg.hd,), jnp.float32),
        } if cfg.qkv_bias else {}
        layers.append({
            **bias,
            "attn_norm": jnp.ones((cfg.dim,), jnp.float32),
            "wq": _dense_init(k[0], (cfg.dim, cfg.n_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wk": _dense_init(k[1], (cfg.dim, cfg.n_kv_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wv": _dense_init(k[2], (cfg.dim, cfg.n_kv_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wo": _dense_init(k[3], (cfg.n_heads * cfg.hd, cfg.dim), cfg.n_heads * cfg.hd, cfg.dtype),
            "mlp_norm": jnp.ones((cfg.dim,), jnp.float32),
            "w_gate": _dense_init(k[4], (cfg.dim, cfg.hidden_dim), cfg.dim, cfg.dtype),
            "w_up": _dense_init(k[5], (cfg.dim, cfg.hidden_dim), cfg.dim, cfg.dtype),
            "w_down": _dense_init(k[6], (cfg.hidden_dim, cfg.dim), cfg.hidden_dim, cfg.dtype),
        })
    return {
        "embed": _dense_init(keys[-2], (cfg.vocab_size, cfg.dim), cfg.dim, cfg.dtype),
        "layers": layers,
        "final_norm": jnp.ones((cfg.dim,), jnp.float32),
        "lm_head": _dense_init(keys[-1], (cfg.dim, cfg.vocab_size), cfg.dim, cfg.dtype),
    }


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    rms = jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * rms * weight).astype(x.dtype)


def rope_cos_sin(positions: jax.Array, head_dim: int, theta: float,
                 factors: Optional[Tuple[float, float, float, float]] = None):
    """positions [.., S] int32 -> cos/sin [.., S, head_dim/2] fp32.

    `factors` enables Llama-3.x RoPE scaling (NTK-by-parts): long-wavelength
    frequencies are divided by `factor`, short ones kept, and the band
    between `low/high_freq_factor` (in units of the ORIGINAL context length)
    interpolated — matching HF `_compute_llama3_parameters` bit-for-bit in
    fp32 so converted Llama-3.1+ checkpoints reproduce transformers logits.
    """
    inv_freq = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim))
    if factors is not None:
        factor, low_f, high_f, orig_max = factors
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_max / low_f       # wavelens beyond this: fully scaled
        high_wl = orig_max / high_f     # wavelens under this: unscaled
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = jnp.where(
            wavelen > low_wl, inv_freq / factor,
            jnp.where(wavelen < high_wl, inv_freq, smoothed))
    angles = positions.astype(jnp.float32)[..., None] * inv_freq
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x [B, S, H, D]; cos/sin broadcastable to [B, S, 1, D/2]."""
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    return out.astype(x.dtype)


def _qkv(layer: Params, h: jax.Array, cfg: LlamaConfig):
    """Pre-RoPE q/k/v projections, applying Qwen2-style additive biases
    ("bq"/"bk"/"bv" keys) and Qwen3-style per-head QK RMSNorm
    ("q_norm"/"k_norm" keys, normalized over head_dim before RoPE) when the
    layer carries them."""
    B, S, _ = h.shape
    q = _mm(h, layer["wq"])
    k = _mm(h, layer["wk"])
    v = _mm(h, layer["wv"])
    if "bq" in layer:
        q = (q.astype(jnp.float32) + layer["bq"]).astype(q.dtype)
        k = (k.astype(jnp.float32) + layer["bk"]).astype(k.dtype)
        v = (v.astype(jnp.float32) + layer["bv"]).astype(v.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if "q_norm" in layer:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.hd)


def _attention_block(
    layer: Params, x: jax.Array, cfg: LlamaConfig,
    cos, sin,
    attention_fn: Callable,
    cache: Optional[Tuple[jax.Array, jax.Array]] = None,
    cache_len: Optional[jax.Array] = None,
):
    B, S, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(layer, h, cfg)
    cs = cos[:, :, None, :]
    sn = sin[:, :, None, :]
    q = apply_rope(q, cs, sn)
    k = apply_rope(k, cs, sn)
    new_cache = None
    if cache is not None:
        ck, cv = cache
        ck = jax.lax.dynamic_update_slice(ck, k, (0, cache_len, 0, 0))
        cv = jax.lax.dynamic_update_slice(cv, v, (0, cache_len, 0, 0))
        new_cache = (ck, cv)
        attn = attention_fn(q, ck, cv, cache_len + S)
    else:
        attn = attention_fn(q, k, v, None)
    out = _mm(attn.reshape(B, S, cfg.n_heads * cfg.hd), layer["wo"])
    if "post_attn_norm" in layer:   # Gemma2: norm the sublayer OUTPUT
        out = rms_norm(out, layer["post_attn_norm"], cfg.norm_eps)
    return x + out, new_cache


def _psum(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    """Reduce a row-parallel partial product over the TP axis (Megatron
    pattern: wo / w_down shard their INPUT dim, so local matmuls produce
    partial sums). No-op outside shard_map."""
    return jax.lax.psum(x, axis_name) if axis_name else x


def _mlp_block(layer: Params, x: jax.Array, cfg: LlamaConfig,
               psum_axis: Optional[str] = None) -> jax.Array:
    if "router" in layer:
        # MoE layer (models/moe.py pytree): every llama code path — training
        # forward, prefill, batched/paged decode, chunked prefill, the
        # serving Engine — serves MoE params through this dispatch. The
        # DENSE all-experts path is used on purpose: capacity routing makes
        # a token's output depend on what else is co-batched (a correctness
        # hazard under continuous batching), while dense is batch-invariant
        # and exact. Expert weights ride replicated under TP serving (only
        # attention shards), so no psum is needed here.
        from fa2_jax.models.moe import moe_mlp_dense

        return moe_mlp_dense(layer, x, cfg)[0]
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    act = {"silu": jax.nn.silu,
           "gelu_tanh": partial(jax.nn.gelu, approximate=True),
           "gelu": partial(jax.nn.gelu, approximate=False)}[cfg.hidden_act]
    gated = act(_mm(h, layer["w_gate"])) * _mm(h, layer["w_up"])
    out = _psum(_mm(gated, layer["w_down"]), psum_axis)
    if "post_mlp_norm" in layer:    # Gemma2 (post-norm AFTER the TP psum)
        out = rms_norm(out, layer["post_mlp_norm"], cfg.norm_eps)
    return x + out


def _logits(x: jax.Array, params: Params, cfg: LlamaConfig) -> jax.Array:
    """LM-head projection (+ Gemma-style final tanh softcap), fp32 out."""
    logits = _mm(x, params["lm_head"]).astype(jnp.float32)
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * jnp.tanh(logits / cfg.logit_softcap)
    return logits


def default_attention(q, k, v, _kv_len):
    return flash_attn_func(q, k, v, causal=True)


def make_cached_attention_fn(cfg: LlamaConfig) -> Callable:
    """Config-driven KV-cache attention for `forward_with_cache` (the
    speculative/greedy cached decode path): plain models get the bare
    4-arg wrapper; models with window/softcap/scale knobs get the per-layer
    (`li` keyword) form that `forward_with_cache` detects and specializes."""
    from fa2_jax.ops.attention import flash_attn_with_kv_cache

    if (cfg.sliding_window < 0 and cfg.attn_softcap == 0.0
            and cfg.attn_scale is None):
        def attn(q, ck, cv, kv_len):
            return flash_attn_with_kv_cache(q, ck, cv, kv_len)
        return attn

    def attn(q, ck, cv, kv_len, li=0):
        return flash_attn_with_kv_cache(
            q, ck, cv, kv_len, softmax_scale=cfg.scale,
            window_left=cfg.window_for(li), softcap=cfg.attn_softcap,
        )
    return attn


def make_attention_fn(cfg: LlamaConfig, li: int = 0) -> Callable:
    """Config-driven training attention for layer `li` (full causal,
    per-layer sliding window, score softcap, explicit scale)."""
    window = cfg.window_for(li)
    if window < 0 and cfg.attn_softcap == 0.0 and cfg.attn_scale is None:
        return default_attention
    # Only pin the scale when the config overrides it — otherwise let the
    # kernel derive 1/sqrt(D) from the tensors (callers may run tensors
    # whose head dim differs from the config's).
    kwargs = dict(causal=True)
    if cfg.attn_scale is not None:
        kwargs["softmax_scale"] = cfg.attn_scale
    if window >= 0:
        kwargs["window_size"] = (window, 0)
    if cfg.attn_softcap > 0.0:
        kwargs["softcap"] = cfg.attn_softcap

    def attn(q, k, v, _kv_len):
        return flash_attn_func(q, k, v, **kwargs)

    return attn


def forward(
    params: Params,
    tokens: jax.Array,            # [B, S] int32
    cfg: LlamaConfig,
    attention_fn: Optional[Callable] = None,
    positions: Optional[jax.Array] = None,
) -> jax.Array:
    """Training/prefill forward pass -> logits [B, S, vocab] (fp32).

    `attention_fn=None` builds the config-driven per-layer attention
    (alternating windows etc.); an explicit fn applies to every layer."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def block(layer, x, fn):
        x, _ = _attention_block(layer, x, cfg, cos, sin, fn)
        return _mlp_block(layer, x, cfg)

    if cfg.remat:
        block = jax.checkpoint(block, static_argnums=(2,))
    for li, layer in enumerate(params["layers"]):
        fn = attention_fn if attention_fn is not None \
            else make_attention_fn(cfg, li)
        x = block(layer, x, fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params, cfg)


def loss_fn(params: Params, tokens: jax.Array, cfg: LlamaConfig,
            attention_fn: Optional[Callable] = None) -> jax.Array:
    """Next-token cross-entropy, mean over positions."""
    logits = forward(params, tokens[:, :-1], cfg, attention_fn)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


# ----------------------------- decoding ---------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int):
    return [
        (
            jnp.zeros((batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.dtype),
            jnp.zeros((batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.dtype),
        )
        for _ in range(cfg.n_layers)
    ]


def prefill_forward(
    params: Params,
    tokens: jax.Array,         # [B, S_pad] int32, right-padded
    true_len: jax.Array,       # [B] int32
    cfg: LlamaConfig,
    psum_axis: Optional[str] = None,
):
    """Prompt prefill: causal self-attention over the (padded) prompt.
    Returns (logits [B, S_pad, V], per-layer (k, v) in BSHD) for cache fill.

    Under TP (inside shard_map, `psum_axis` set): cfg carries the LOCAL head
    counts, q/k/v are head-sharded, and the wo / w_down partial products are
    psum-reduced (the emitted k/v stay local — the KV cache is head-sharded
    along the same axis)."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    mask = positions < true_len[:, None]
    kvs = []
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        kvs.append((k, v))
        w = cfg.window_for(li)
        attn = flash_attn_func(
            q, k, v, attention_mask=mask, causal=True,
            softmax_scale=cfg.scale, softcap=cfg.attn_softcap,
            window_size=(w, 0) if w >= 0 else (-1, -1),
        )
        out = _psum(
            _mm(attn.reshape(B, S, cfg.n_heads * cfg.hd), layer["wo"]),
            psum_axis,
        )
        if "post_attn_norm" in layer:
            out = rms_norm(out, layer["post_attn_norm"], cfg.norm_eps)
        x = x + out
        x = _mlp_block(layer, x, cfg, psum_axis)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params, cfg), kvs


def chunk_prefill_step(
    params: Params,
    tokens: jax.Array,        # [1, C] int32 — one padded prompt chunk
    chunk_len: jax.Array,     # [1] int32 — true tokens in this chunk
    cache_len: jax.Array,     # [1] int32 — tokens already in the slot cache
    cfg: LlamaConfig,
    caches,                   # single-slot runtime cache views (B == 1)
    kv_cfg,                   # runtime.kv_cache.KVCacheConfig
    psum_axis: Optional[str] = None,
):
    """One BOUNDED prefill chunk over the serving KV cache: the chunk's
    queries attend to the already-cached prefix plus the chunk itself
    (causal, via the forward kernel's global q_offset — the same contract
    `flash_attn_with_kv_cache` uses), and the chunk's k/v are written at
    `cache_len`. Long prompts stop stalling decode: the engine interleaves
    one chunk per step with the batched decode (`runtime/serving.py`).

    Returns (logits of the chunk's LAST true token [1, V], new_caches).
    """
    from fa2_jax.ops.flash_fwd import flash_attn_forward
    from fa2_jax.ops.tuning import choose_block_sizes
    from fa2_jax.runtime.kv_cache import write_kv
    from fa2_jax.utils import round_up_to_multiple

    B, C = tokens.shape
    x = params["embed"][tokens]
    cl = cache_len[0]
    positions = cl + jnp.arange(C, dtype=jnp.int32)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    total = cl + chunk_len[0]
    S_max = caches[0]["k"].shape[2]
    lens = jnp.broadcast_to(jnp.stack([total, total]).reshape(1, 2), (B, 2))
    scalars = jnp.stack(
        [cl, jnp.int32(0), jnp.int32(0), jnp.int32(0)]).reshape(1, 4)
    Dp = kv_cfg.head_dim_padded
    blocks = choose_block_sizes(C, S_max, Dp)
    Cp = round_up_to_multiple(C, blocks.block_q)
    # block_kv must divide the cache extent (a multiple of 16).
    block_kv = blocks.block_kv
    while S_max % block_kv:
        block_kv //= 2
    new_caches = []
    for li, (layer, cache) in enumerate(zip(params["layers"], caches)):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q, k = apply_rope(q, cs, sn), apply_rope(k, cs, sn)
        cache = write_kv(cache, k, v, cache_len, kv_cfg)
        new_caches.append(cache)
        kc, vc = cache["k"], cache["v"]
        if kv_cfg.qdtype is not None:
            # Chunk attention runs on the dequantized prefix (the fused
            # dequant lives in the single-row decode kernel; a C-row chunk
            # reuses the training-grade forward kernel instead).
            kc = (kc.astype(jnp.float32)
                  * jnp.swapaxes(cache["k_scale"], 2, 3)).astype(
                      kv_cfg.compute_dtype)
            vc = (vc.astype(jnp.float32)
                  * jnp.swapaxes(cache["v_scale"], 2, 3)).astype(
                      kv_cfg.compute_dtype)
        qT = jnp.transpose(q, (0, 2, 1, 3))      # BHSD
        if Dp != cfg.hd:
            qT = jnp.pad(qT, ((0, 0), (0, 0), (0, 0), (0, Dp - cfg.hd)))
        if Cp != C:
            qT = jnp.pad(qT, ((0, 0), (0, 0), (0, Cp - C), (0, 0)))
        w = cfg.window_for(li)
        o, _ = flash_attn_forward(
            qT.astype(kv_cfg.compute_dtype), kc, vc, lens, scalars, None,
            causal=True, softmax_scale=cfg.scale,
            window=(w, 0) if w >= 0 else (-1, -1),
            softcap=cfg.attn_softcap,
            seqlen_q_real=C, seqlen_k_real=S_max,
            block_q=blocks.block_q, block_kv=block_kv,
        )
        attn = jnp.transpose(o[:, :, :C, :cfg.hd], (0, 2, 1, 3))
        out = _psum(
            _mm(attn.reshape(B, C, cfg.n_heads * cfg.hd).astype(x.dtype),
                layer["wo"]),
            psum_axis,
        )
        if "post_attn_norm" in layer:
            out = rms_norm(out, layer["post_attn_norm"], cfg.norm_eps)
        x = x + out
        x = _mlp_block(layer, x, cfg, psum_axis)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = jax.lax.dynamic_slice_in_dim(x, chunk_len[0] - 1, 1, axis=1)[:, 0]
    return _logits(last, params, cfg), new_caches


def decode_step(
    params: Params,
    tokens: jax.Array,        # [B] int32 — one token per slot
    cfg: LlamaConfig,
    caches,                   # runtime KV cache: list of layer dicts (BHSD)
    lens: jax.Array,          # [B] int32 — tokens already in each slot
    kv_cfg,                   # runtime.kv_cache.KVCacheConfig
    psum_axis: Optional[str] = None,
):
    """One batched decode step over the serving KV cache (per-slot lengths,
    quantized storage, `ops/decode.py` kernel). Returns (logits [B, V],
    new_caches). Under TP, cfg/kv_cfg carry LOCAL head counts and the
    output projections psum over `psum_axis` (see prefill_forward)."""
    from fa2_jax.ops.decode import decode_attention
    from fa2_jax.runtime.kv_cache import write_kv

    B = tokens.shape[0]
    x = params["embed"][tokens][:, None, :]       # [B, 1, dim]
    cos, sin = rope_cos_sin(lens[:, None], cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    Dp = kv_cfg.head_dim_padded
    new_caches = []
    for li, (layer, cache) in enumerate(zip(params["layers"], caches)):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, cs, sn)
        k = apply_rope(k, cs, sn)
        cache = write_kv(cache, k, v, lens, kv_cfg)
        new_caches.append(cache)
        qp = q[:, 0]
        if Dp != cfg.hd:
            qp = jnp.pad(qp, ((0, 0), (0, 0), (0, Dp - cfg.hd)))
        attn = decode_attention(
            qp, cache["k"], cache["v"], lens + 1,
            cache.get("k_scale"), cache.get("v_scale"),
            # Scale from the MODEL head dim, not the padded one.
            softmax_scale=cfg.scale,
            block_kv=kv_cfg.block_kv,
            window_left=cfg.window_for(li),
            softcap=cfg.attn_softcap,
        )[:, :, :cfg.hd]
        out = _psum(
            _mm(attn.reshape(B, 1, cfg.n_heads * cfg.hd), layer["wo"]),
            psum_axis,
        )
        if "post_attn_norm" in layer:
            out = rms_norm(out, layer["post_attn_norm"], cfg.norm_eps)
        x = x + out
        x = _mlp_block(layer, x, cfg, psum_axis)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, 0], params, cfg), new_caches


def forward_with_cache(
    params: Params,
    tokens: jax.Array,             # [B, S_step]
    cfg: LlamaConfig,
    caches,                        # list of (k, v) per layer
    cache_len: jax.Array,          # scalar int32: tokens already in cache
    cached_attention_fn: Callable, # (q, k_cache, v_cache, kv_len[, li]) -> out
):
    """One prefill/decode step; returns (logits [B, S_step, V], new caches).

    `cached_attention_fn` may take an optional trailing `li` (layer index)
    keyword to specialize per layer (Gemma2's alternating windows)."""
    import inspect

    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = cache_len + jnp.arange(S, dtype=jnp.int32)
    positions = jnp.broadcast_to(positions, (B, S))
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
    per_layer = "li" in inspect.signature(cached_attention_fn).parameters
    new_caches = []
    for li, (layer, cache) in enumerate(zip(params["layers"], caches)):
        fn = (partial(cached_attention_fn, li=li) if per_layer
              else cached_attention_fn)
        x, new_cache = _attention_block(
            layer, x, cfg, cos, sin, fn,
            cache=cache, cache_len=cache_len,
        )
        new_caches.append(new_cache)
        x = _mlp_block(layer, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params, cfg), new_caches


QUANTIZABLE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_model_params(params: Params, qdtype=jnp.int8) -> Params:
    """Weight-only quantization (north-star INT8/FP8 weights): every large
    matmul weight becomes {qvalues, qscale} with per-output-channel scales;
    embeddings and norms stay high precision. All forward paths dispatch via
    `ops.quant.qmatmul`, which fuses dequant into the matmul epilogue."""
    def convert(d):
        return {
            k: (quantize_weight(w, qdtype) if k in QUANTIZABLE_KEYS else w)
            for k, w in d.items()
        }

    out = dict(params)
    out["layers"] = [convert(layer) for layer in params["layers"]]
    out["lm_head"] = quantize_weight(params["lm_head"], qdtype)
    return out


def paged_decode_step(
    params: Params,
    tokens: jax.Array,        # [B] int32 — one token per slot
    cfg: LlamaConfig,
    pools,                    # per-layer page-pool dicts (shared pages)
    tables: jax.Array,        # [n_slots, max_pages] int32 block tables
    lens: jax.Array,          # [B] int32 — tokens already in each slot
    pcfg,                     # runtime.paged_cache.PagedCacheConfig
    psum_axis: Optional[str] = None,
):
    """One batched decode step over the PAGED KV cache (vLLM-style block
    tables; `ops/decode.py:paged_decode_attention`). Returns
    (logits [B, V], new_pools). Under TP the page pools are head-sharded
    (block tables replicated) and cfg/pcfg carry LOCAL head counts."""
    from fa2_jax.ops.decode import paged_decode_attention
    from fa2_jax.runtime.paged_cache import write_tokens_paged

    B = tokens.shape[0]
    x = params["embed"][tokens][:, None, :]
    cos, sin = rope_cos_sin(lens[:, None], cfg.hd, cfg.rope_theta, cfg.rope_factors)
    cs, sn = cos[:, :, None, :], sin[:, :, None, :]
    Dp = pcfg.head_dim_padded
    new_pools = []
    for li, (layer, pool) in enumerate(zip(params["layers"], pools)):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, cs, sn)
        k = apply_rope(k, cs, sn)
        pool = write_tokens_paged(pool, tables, k, v, lens, pcfg)
        new_pools.append(pool)
        qp = q[:, 0]
        if Dp != cfg.hd:
            qp = jnp.pad(qp, ((0, 0), (0, 0), (0, Dp - cfg.hd)))
        attn = paged_decode_attention(
            qp, pool["k"], pool["v"], tables, lens + 1,
            pool.get("k_scale"), pool.get("v_scale"),
            softmax_scale=cfg.scale,
            window_left=cfg.window_for(li),
            softcap=cfg.attn_softcap,
        )[:, :, :cfg.hd]
        out = _psum(
            _mm(attn.reshape(B, 1, cfg.n_heads * cfg.hd), layer["wo"]),
            psum_axis,
        )
        if "post_attn_norm" in layer:
            out = rms_norm(out, layer["post_attn_norm"], cfg.norm_eps)
        x = x + out
        x = _mlp_block(layer, x, cfg, psum_axis)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, 0], params, cfg), new_pools
