"""LoRA (low-rank adaptation) fine-tuning for the model families.

Shape: adapters are held as a separate pytree and **merged
functionally into the base weights inside the jitted step**
(`W + (alpha/r) * A @ B`). XLA folds the rank-r update into the existing
matmul schedule, so every downstream path — training forward, the serving
Engine, TP/FSDP sharding, quantized decode after re-quantization — works on
adapted models unchanged; no per-layer module surgery, no second matmul on
the serving path. Training differentiates only w.r.t. the adapter pytree
(the base stays frozen), which with optimizer state on just the adapters is
the usual LoRA memory win.

The adapter pytree contains ONLY arrays (rank is recovered from A's shape,
alpha is a call-site constant), so it drops straight into optax.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

# 2-D projection weights adapters attach to by default (llama + MoE attn).
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(
    key: jax.Array,
    params: Params,
    rank: int = 8,
    targets: Iterable[str] = DEFAULT_TARGETS,
) -> Params:
    """Adapter pytree mirroring `params['layers']`: for each targeted 2-D
    weight [in, out], A [in, r] (scaled-normal init) and B [r, out] (zeros —
    the adapted model starts EXACTLY at the base model)."""
    targets = tuple(targets)
    layers = []
    for layer in params["layers"]:
        adapters = {}
        for name in targets:
            w = layer.get(name)
            if w is None or getattr(w, "ndim", 0) != 2:
                continue
            key, k = jax.random.split(key)
            fan_in, fan_out = w.shape
            adapters[name] = {
                "a": (jax.random.normal(k, (fan_in, rank), jnp.float32)
                      / math.sqrt(fan_in)).astype(w.dtype),
                "b": jnp.zeros((rank, fan_out), w.dtype),
            }
        layers.append(adapters)
    return {"layers": layers}


def merge_lora(params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """Base + adapters -> plain params pytree (same structure/dtypes as the
    base), usable by every forward/serving/sharding path. Jit-safe: under a
    jitted loss the merge is traced per step and only `lora` is
    differentiated. Scale = alpha / rank (rank read off A)."""

    def merge_layer(layer, adapters):
        out = dict(layer)
        for name, ab in adapters.items():
            scale = alpha / ab["a"].shape[1]
            delta = (ab["a"].astype(jnp.float32)
                     @ ab["b"].astype(jnp.float32)) * scale
            out[name] = (layer[name].astype(jnp.float32)
                         + delta).astype(layer[name].dtype)
        return out

    out = dict(params)
    out["layers"] = [merge_layer(l, a)
                     for l, a in zip(params["layers"], lora["layers"])]
    return out


def lora_loss_fn(base_params: Params, lora: Params, tokens: jax.Array,
                 cfg, loss_fn, alpha: float = 16.0) -> jax.Array:
    """`loss_fn(merge(base, lora), tokens, cfg)` — differentiate w.r.t.
    `lora` only (e.g. `jax.grad(lora_loss_fn, argnums=1)`)."""
    return loss_fn(merge_lora(base_params, lora, alpha), tokens, cfg)
