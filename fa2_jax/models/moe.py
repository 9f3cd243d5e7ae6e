"""Mixtral-style mixture-of-experts decoder on the flash-attention kernels.

The reference is a kernel library with no model layer; this extends the
north-star model zoo (llama.py, gpt2.py) with a sparse-MLP family and the
`ep` (expert-parallel) sharding axis used by `__graft_entry__.dryrun_multichip`.

Design choices:
- **Static-shape GShard dispatch**: routing uses one-hot dispatch/combine
  tensors with a fixed per-expert capacity (no gather/scatter, no dynamic
  shapes), so everything lowers to dense einsums that XLA can tile. Tokens
  beyond capacity are dropped (their MLP contribution is zero and the
  residual passes through) — exact vs. the dense reference whenever capacity
  suffices, which the tests pin.
- **Choice-priority capacity**: all first choices claim capacity before any
  second choice, so overflow degrades the k-th expert first (Switch/GShard
  convention).
- **Expert parallelism by annotation**: expert weights are stacked on a
  leading E axis and sharded over the mesh's `model` axis
  (`moe_param_pspecs`). Under `jit` XLA turns the dispatch/compute/combine
  einsums into an expert-sharded pipeline with the collectives (all-reduce of
  the combine contraction) inserted automatically — the scaling-book recipe:
  pick a mesh, annotate, let XLA place the collectives.
- Attention is identical to llama.py (RoPE + GQA flash kernels), so every
  kernel feature (causal, window, dropout) carries
  over unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fa2_jax.models.llama import (
    LlamaConfig,
    _attention_block,
    _dense_init,
    make_attention_fn,
    rms_norm,
    rope_cos_sin,
)
from fa2_jax.parallel.mesh import AXIS_MODEL

Params = Dict[str, Any]


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert capacity = ceil(top_k * tokens / n_experts) * capacity_factor.
    capacity_factor: float = 1.25
    # Switch-transformer load-balancing aux loss coefficient.
    router_aux_coef: float = 0.01


def init_params(key: jax.Array, cfg: MoEConfig) -> Params:
    keys = jax.random.split(key, cfg.n_layers + 2)
    E = cfg.n_experts
    layers = []
    for li in range(cfg.n_layers):
        k = jax.random.split(keys[li], 8)
        layers.append({
            "attn_norm": jnp.ones((cfg.dim,), jnp.float32),
            "wq": _dense_init(k[0], (cfg.dim, cfg.n_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wk": _dense_init(k[1], (cfg.dim, cfg.n_kv_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wv": _dense_init(k[2], (cfg.dim, cfg.n_kv_heads * cfg.hd), cfg.dim, cfg.dtype),
            "wo": _dense_init(k[3], (cfg.n_heads * cfg.hd, cfg.dim), cfg.n_heads * cfg.hd, cfg.dtype),
            "mlp_norm": jnp.ones((cfg.dim,), jnp.float32),
            # Router stays fp32: tiny, and routing decisions are
            # precision-sensitive (a bf16 tie flips expert assignment).
            "router": _dense_init(k[4], (cfg.dim, E), cfg.dim, jnp.float32),
            # Experts stacked on a leading E axis — the EP sharding axis.
            "we_gate": _dense_init(k[5], (E, cfg.dim, cfg.hidden_dim), cfg.dim, cfg.dtype),
            "we_up": _dense_init(k[6], (E, cfg.dim, cfg.hidden_dim), cfg.dim, cfg.dtype),
            "we_down": _dense_init(k[7], (E, cfg.hidden_dim, cfg.dim), cfg.hidden_dim, cfg.dtype),
        })
    return {
        "embed": _dense_init(keys[-2], (cfg.vocab_size, cfg.dim), cfg.dim, cfg.dtype),
        "layers": layers,
        "final_norm": jnp.ones((cfg.dim,), jnp.float32),
        "lm_head": _dense_init(keys[-1], (cfg.dim, cfg.vocab_size), cfg.dim, cfg.dtype),
    }


def _route(h2d: jax.Array, router: jax.Array, cfg: MoEConfig):
    """Router: fp32 logits -> (top-k weights [T,k], indices [T,k], probs [T,E]).

    Top-k softmax weights are renormalized to sum to 1 (Mixtral convention).
    """
    logits = h2d.astype(jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    weights, idx = jax.lax.top_k(probs, cfg.top_k)
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    return weights, idx, probs


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor)
    return max(int(c), 1)


def _aux_loss(probs: jax.Array, idx: jax.Array, cfg: MoEConfig) -> jax.Array:
    """Switch-style load-balance loss: E * Σ_e fraction_e · importance_e."""
    E = cfg.n_experts
    assign = jax.nn.one_hot(idx, E, dtype=jnp.float32)     # [T, k, E]
    fraction = jnp.mean(jnp.sum(assign, axis=1), axis=0)   # [E], mean over T
    importance = jnp.mean(probs, axis=0)                   # [E]
    return E * jnp.sum(fraction * importance) / cfg.top_k


def _dispatch_tensors(h: jax.Array, layer: Params, cfg: MoEConfig, C: int):
    """Routing -> static one-hot (dispatch, combine) [T, E, C] + aux loss.

    Choice-priority positions: the k choices are flattened j-major so every
    primary choice claims capacity before any secondary one (GShard/Switch
    convention); tokens past capacity are dropped from that expert.
    """
    T = h.shape[0]
    E = cfg.n_experts
    weights, idx, probs = _route(h, layer["router"], cfg)
    mask = jax.nn.one_hot(idx, E, dtype=jnp.int32)            # [T, k, E]
    mask_f = jnp.transpose(mask, (1, 0, 2)).reshape(cfg.top_k * T, E)
    pos = jnp.cumsum(mask_f, axis=0) - 1                      # [kT, E]
    within = jnp.sum(pos * mask_f, axis=-1)                   # [kT]
    keep = within < C
    slot = jax.nn.one_hot(within, C, dtype=h.dtype) * keep[:, None].astype(h.dtype)
    # dispatch[t, e, c] = 1 iff token t sits in slot c of expert e.
    disp = mask_f.astype(h.dtype)[:, :, None] * slot[:, None, :]
    disp = jnp.sum(disp.reshape(cfg.top_k, T, E, C), axis=0)  # [T, E, C]
    w_f = jnp.transpose(weights, (1, 0)).reshape(cfg.top_k * T)
    comb = (mask_f.astype(jnp.float32) * w_f[:, None])[:, :, None] \
        * slot.astype(jnp.float32)[:, None, :]
    comb = jnp.sum(comb.reshape(cfg.top_k, T, E, C), axis=0)  # [T, E, C]
    return disp, comb, _aux_loss(probs, idx, cfg)


def _expert_compute(we_gate, we_up, we_down, h, disp, comb) -> jax.Array:
    """Batched per-expert SwiGLU over the dispatched buffers -> [T, D].

    Pure dense einsums over whatever slice of the E axis the caller holds —
    under explicit EP (shard_map) each device passes its local experts and
    the caller psums the result over the expert axis.
    """
    xs = jnp.einsum("tec,td->ecd", disp, h)                   # [E, C, D]
    gated = jax.nn.silu(jnp.einsum("ecd,edh->ech", xs, we_gate)) \
        * jnp.einsum("ecd,edh->ech", xs, we_up)
    ys = jnp.einsum("ech,ehd->ecd", gated, we_down)           # [E, C, D]
    return jnp.einsum("tec,ecd->td", comb.astype(ys.dtype), ys)


def moe_mlp(layer: Params, x: jax.Array, cfg: MoEConfig,
            capacity: Optional[int] = None) -> Tuple[jax.Array, jax.Array]:
    """Sparse MoE MLP block (pre-norm, residual). Returns (out, aux_loss).

    Static-shape dispatch: one-hot [T, E, C] tensors route tokens into
    per-expert buffers; expert SwiGLU runs as batched [E, C, ·] einsums on
    the tensor cores; the combine einsum contracts (E, C) back per token. With the E
    axis of the `we_*` weights sharded (see `moe_param_pspecs`) this is
    expert parallelism: each shard computes its experts' buffers and the
    combine contraction all-reduces over the expert axis.
    """
    B, S, D = x.shape
    T = B * S
    C = _capacity(cfg, T) if capacity is None else capacity
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(T, D)
    disp, comb, aux = _dispatch_tensors(h, layer, cfg, C)
    out = _expert_compute(layer["we_gate"], layer["we_up"], layer["we_down"],
                          h, disp, comb)
    return x + out.reshape(B, S, D).astype(x.dtype), aux


def make_ep_mlp(mesh, axis: str = AXIS_MODEL) -> Callable:
    """Explicit expert parallelism: an `mlp_fn` whose expert compute runs
    under `shard_map` with the stacked-E weight axis sharded over `axis`.

    Routing and the dispatch/combine tensors are computed replicated (the
    router is tiny); each device then builds buffers only for its local
    E/axis_size experts and the per-token combine partial sums are
    `psum`-reduced over the expert axis — the collective pattern EP
    needs, stated explicitly rather than left to the partitioner.
    """
    def mlp_fn(layer: Params, x: jax.Array, cfg: MoEConfig,
               capacity: Optional[int] = None):
        B, S, D = x.shape
        T = B * S
        C = _capacity(cfg, T) if capacity is None else capacity
        assert cfg.n_experts % mesh.shape[axis] == 0, \
            (cfg.n_experts, mesh.shape[axis])
        h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(T, D)
        disp, comb, aux = _dispatch_tensors(h, layer, cfg, C)

        def local(wg, wu, wd, h_, disp_, comb_):
            return jax.lax.psum(
                _expert_compute(wg, wu, wd, h_, disp_, comb_), axis)

        eshard = P(axis, None, None)
        out = jax.shard_map(
            local, mesh=mesh,
            in_specs=(eshard, eshard, eshard, P(None, None),
                      P(None, axis, None), P(None, axis, None)),
            out_specs=P(None, None),
        )(layer["we_gate"], layer["we_up"], layer["we_down"], h, disp, comb)
        return x + out.reshape(B, S, D).astype(x.dtype), aux

    return mlp_fn


def moe_mlp_dense(layer: Params, x: jax.Array, cfg: MoEConfig
                  ) -> Tuple[jax.Array, jax.Array]:
    """Dense oracle for `moe_mlp`: every expert computed for every token,
    combined with the (renormalized) top-k router weights. O(E) FLOPs —
    test/debug only; must match `moe_mlp` exactly when capacity suffices."""
    B, S, D = x.shape
    T = B * S
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(T, D)
    weights, idx, probs = _route(h, layer["router"], cfg)
    gated = jax.nn.silu(jnp.einsum("td,edh->teh", h, layer["we_gate"])) \
        * jnp.einsum("td,edh->teh", h, layer["we_up"])
    ys = jnp.einsum("teh,ehd->ted", gated, layer["we_down"])  # [T, E, D]
    w_full = jnp.zeros((T, cfg.n_experts), jnp.float32)
    w_full = jax.vmap(lambda w, i, wf: wf.at[i].add(w))(weights, idx, w_full)
    out = jnp.einsum("te,ted->td", w_full.astype(ys.dtype), ys)
    return x + out.reshape(B, S, D).astype(x.dtype), _aux_loss(probs, idx, cfg)


def forward(
    params: Params,
    tokens: jax.Array,
    cfg: MoEConfig,
    attention_fn: Optional[Callable] = None,
    return_aux: bool = False,
    mlp_fn: Callable = moe_mlp,
):
    """Training forward -> logits [B, S, vocab] (fp32), optionally with the
    summed router aux loss."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def block(layer, x, fn):
        x, _ = _attention_block(layer, x, cfg, cos, sin, fn)
        return mlp_fn(layer, x, cfg)

    if cfg.remat:
        block = jax.checkpoint(block, static_argnums=(2,))
    aux = jnp.float32(0.0)
    for li, layer in enumerate(params["layers"]):
        fn = attention_fn if attention_fn is not None \
            else make_attention_fn(cfg, li)
        x, a = block(layer, x, fn)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).astype(jnp.float32)
    return (logits, aux) if return_aux else logits


def loss_fn(params: Params, tokens: jax.Array, cfg: MoEConfig,
            attention_fn: Optional[Callable] = None) -> jax.Array:
    """Next-token cross-entropy + router load-balance aux."""
    logits, aux = forward(params, tokens[:, :-1], cfg, attention_fn,
                          return_aux=True)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll) + cfg.router_aux_coef * aux


_MOE_TP_TABLE = {
    # Attention stays TP over heads (llama table); experts shard on E.
    "wq": P(None, AXIS_MODEL),
    "wk": P(None, AXIS_MODEL),
    "wv": P(None, AXIS_MODEL),
    "wo": P(AXIS_MODEL, None),
    "router": P(None, None),
    "we_gate": P(AXIS_MODEL, None, None),
    "we_up": P(AXIS_MODEL, None, None),
    "we_down": P(AXIS_MODEL, None, None),
}


def moe_param_pspecs(params: Params) -> dict:
    """Expert-parallel PartitionSpecs: the stacked-E axis of each expert
    weight shards over the mesh `model` axis (EP replaces per-expert TP on
    MoE layers); attention weights shard over heads as in llama. Requires
    n_experts % mesh.shape['model'] == 0 and n_experts >= the axis size."""
    def spec(path, leaf):
        name = [p.key if hasattr(p, "key") else str(p) for p in path][-1]
        return _MOE_TP_TABLE.get(name, P())

    return jax.tree_util.tree_map_with_path(spec, params)
