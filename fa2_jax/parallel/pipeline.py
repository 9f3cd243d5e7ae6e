"""Pipeline parallelism (GPipe schedule) via shard_map + ppermute.

The reference has no distributed layer (SURVEY.md §2.4); this completes the
framework's parallelism matrix (dp/tp/sp/ep/pp). Shape: the whole
schedule is one `lax.scan` inside `shard_map` over a `pipe` mesh axis —
every device runs the same traced program, stage-boundary transfers are
`ppermute`s, and reverse-mode AD differentiates the schedule
for free (the transpose of `ppermute` is the reverse permute, so backward is
automatically the mirrored pipeline).

Schedule: M microbatches through P stages in M + P - 1 ticks. Per tick every
device applies its stage to the activation it holds and forwards the result
one hop; stage 0 ingests microbatch t, stage P-1 banks the finished
microbatch t-(P-1). Warmup/drain bubbles compute on zero activations (finite
through norms) and their results are masked out of the banked outputs, so
the bubble costs time but never correctness.

Layer-to-stage mapping: stack the per-layer param pytrees on a leading axis
and shard it over `pipe` — each stage scans its local layers. Embedding and
the LM head run replicated outside the pipelined region.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fa2_jax.parallel.mesh import AXIS_PIPE

Params = Dict[str, Any]


def stack_layer_params(layers) -> Params:
    """[{...}] * L -> {...: [L, ...]} — the leading axis is the one
    `pipe`-sharded (L % n_stages == 0 required at use time)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *layers)


def shard_stacked_layers(stacked: Params, mesh: Mesh) -> Params:
    """Place the stacked-layer pytree with the leading (layer) axis sharded
    over the pipe axis; each stage then holds L/P consecutive layers."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P(AXIS_PIPE, *([None] * (x.ndim - 1))))),
        stacked,
    )


def make_pipeline(
    mesh: Mesh,
    stage_fn: Callable[[Params, jax.Array], jax.Array],
    n_microbatches: int,
    axis: str = AXIS_PIPE,
) -> Callable[[Params, jax.Array], jax.Array]:
    """Build `pipeline(stacked_params, x_microbatched) -> y_microbatched`.

    stage_fn(local_layers, x) applies one stage's layers to one microbatch
    activation [mb, ...]; it must map zeros to finite values (standard
    pre-norm blocks do). `x_microbatched` is [M, mb, ...] and comes back the
    same shape, replicated. The stacked params' leading layer axis is split
    over `axis`; activations and outputs are replicated across it (combine
    with data/tensor axes by sharding the microbatch dims as usual).
    """
    n_stages = int(mesh.shape[axis])
    M = n_microbatches
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def pipelined(local_layers: Params, xs: jax.Array) -> jax.Array:
        idx = jax.lax.axis_index(axis)
        state = jnp.zeros_like(xs[0])
        banked = jnp.zeros_like(xs)

        def tick(carry, t):
            state, banked = carry
            inp = jnp.where(idx == 0, xs[jnp.clip(t, 0, M - 1)], state)
            out = stage_fn(local_layers, inp)
            m = t - (n_stages - 1)
            mc = jnp.clip(m, 0, M - 1)
            write = (idx == n_stages - 1) & (m >= 0)
            banked = banked.at[mc].set(jnp.where(write, out, banked[mc]))
            state = jax.lax.ppermute(out, axis, perm)
            return (state, banked), None

        (state, banked), _ = jax.lax.scan(
            tick, (state, banked), jnp.arange(M + n_stages - 1))
        # Results live on the last stage; replicate via a masked psum.
        return jax.lax.psum(
            jnp.where(idx == n_stages - 1, banked, jnp.zeros_like(banked)),
            axis,
        )

    return jax.shard_map(
        pipelined,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )


def make_llama_pipeline_forward(
    mesh: Mesh,
    cfg,
    n_microbatches: int,
    attention_fn: Optional[Callable] = None,
):
    """LLaMA adapter: `fn(pipe_params, tokens [B, S]) -> logits` where
    `pipe_params` = {embed, stacked (layer-stacked, pipe-sharded), final_norm,
    lm_head}; B must split into n_microbatches. Build pipe_params with
    `pipeline_params_from_llama`."""
    from fa2_jax.models.llama import (
        _attention_block, _mlp_block, make_attention_fn, rms_norm,
        rope_cos_sin,
    )

    # Layers run under lax.scan (one traced body for every layer), so
    # per-layer attention specialization is impossible here — refuse
    # non-uniform window configs loudly instead of silently mis-masking.
    assert getattr(cfg, "uniform_window", True), \
        "pipeline stages scan layers: alternating/per-layer windows unsupported"
    attn_fn = attention_fn or make_attention_fn(cfg)
    n_stages = int(mesh.shape[AXIS_PIPE])
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)

    def stage_fn(local_layers: Params, x: jax.Array) -> jax.Array:
        mb, S, _ = x.shape
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (mb, S))
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

        def body(x, layer):
            x, _ = _attention_block(layer, x, cfg, cos, sin, attn_fn)
            return _mlp_block(layer, x, cfg), None

        x, _ = jax.lax.scan(body, x, local_layers)
        return x

    pipeline = make_pipeline(mesh, stage_fn, n_microbatches)

    def forward(pipe_params: Params, tokens: jax.Array) -> jax.Array:
        B, S = tokens.shape
        assert B % n_microbatches == 0, (B, n_microbatches)
        x = pipe_params["embed"][tokens]
        xs = x.reshape(n_microbatches, B // n_microbatches, S, -1)
        ys = pipeline(pipe_params["stacked"], xs).reshape(B, S, -1)
        ys = rms_norm(ys, pipe_params["final_norm"], cfg.norm_eps)
        return (ys @ pipe_params["lm_head"]).astype(jnp.float32)

    return forward


def _stacked_3d_specs(stacked: Params) -> Params:
    """Per-leaf PartitionSpecs for the layer-stacked pytree under the
    composed pp x tp mesh: leading layer axis on `pipe`, Megatron head/hidden
    sharding on `model` (wq/wk/wv/w_gate/w_up shard the output dim, wo/w_down
    the input dim), norms pipe-only."""
    from fa2_jax.parallel.mesh import AXIS_MODEL

    table = {
        "wq": P(AXIS_PIPE, None, AXIS_MODEL),
        "wk": P(AXIS_PIPE, None, AXIS_MODEL),
        "wv": P(AXIS_PIPE, None, AXIS_MODEL),
        "wo": P(AXIS_PIPE, AXIS_MODEL, None),
        "w_gate": P(AXIS_PIPE, None, AXIS_MODEL),
        "w_up": P(AXIS_PIPE, None, AXIS_MODEL),
        "w_down": P(AXIS_PIPE, AXIS_MODEL, None),
    }

    def spec(path, leaf):
        name = [p.key if hasattr(p, "key") else str(p) for p in path][-1]
        return table.get(name, P(AXIS_PIPE))

    return jax.tree_util.tree_map_with_path(spec, stacked)


def make_llama_3d_forward(
    mesh: Mesh,
    cfg,
    n_microbatches: int,
):
    """Composed pp x dp x tp training forward: the GPipe schedule over
    `pipe`, microbatch batch dim sharded over `data`, and Megatron tensor
    parallelism over `model` inside every stage (local-head flash attention
    — collective-free, the GQA head axis shards cleanly — plus psum'd
    wo/w_down row-parallel projections). One shard_map over all three axes;
    reverse-mode AD transposes psum/ppermute so grads pipeline too.

    Returns `fn(pipe_params, tokens [B, S]) -> logits` with B divisible by
    n_microbatches * data. Build pipe_params with
    `pipeline_params_from_llama(params, mesh, tp=True)`.
    """
    import dataclasses

    from fa2_jax.models.llama import rms_norm, rope_cos_sin, apply_rope
    from fa2_jax.ops.attention import flash_attn_func
    from fa2_jax.parallel.mesh import AXIS_DATA, AXIS_MODEL

    n_stages = int(mesh.shape[AXIS_PIPE])
    tp = int(mesh.shape.get(AXIS_MODEL, 1))
    M = n_microbatches
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0, \
        (cfg.n_heads, cfg.n_kv_heads, tp)
    assert getattr(cfg, "uniform_window", True), \
        "pipeline stages scan layers: alternating/per-layer windows unsupported"
    hq, hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    window = (cfg.sliding_window, 0) if cfg.sliding_window >= 0 else (-1, -1)
    attn_kw = dict(causal=True, window_size=window,
                   softcap=getattr(cfg, "attn_softcap", 0.0))
    if getattr(cfg, "attn_scale", None) is not None:
        attn_kw["softmax_scale"] = cfg.attn_scale
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def stage_fn(local_layers: Params, x: jax.Array) -> jax.Array:
        mb, S, _ = x.shape
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (mb, S))
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)
        cs, sn = cos[:, :, None, :], sin[:, :, None, :]

        def psum_tp(v):
            return jax.lax.psum(v, AXIS_MODEL) if tp > 1 else v

        def body(x, layer):
            h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
            q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
            if "bq" in layer:  # Qwen2-style additive qkv biases
                q = (q.astype(jnp.float32) + layer["bq"]).astype(q.dtype)
                k = (k.astype(jnp.float32) + layer["bk"]).astype(k.dtype)
                v = (v.astype(jnp.float32) + layer["bv"]).astype(v.dtype)
            q = q.reshape(mb, S, hq, cfg.hd)
            k = k.reshape(mb, S, hkv, cfg.hd)
            if "q_norm" in layer:  # Qwen3-style per-head QK RMSNorm
                q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
                k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
            q = apply_rope(q, cs, sn)
            k = apply_rope(k, cs, sn)
            v = v.reshape(mb, S, hkv, cfg.hd)
            attn = flash_attn_func(q, k, v, **attn_kw)
            x = x + psum_tp(attn.reshape(mb, S, hq * cfg.hd) @ layer["wo"])
            h2 = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
            gated = jax.nn.silu(h2 @ layer["w_gate"]) * (h2 @ layer["w_up"])
            return x + psum_tp(gated @ layer["w_down"]), None

        return jax.lax.scan(body, x, local_layers)[0]

    def pipelined(local_layers: Params, xs: jax.Array) -> jax.Array:
        idx = jax.lax.axis_index(AXIS_PIPE)
        state = jnp.zeros_like(xs[0])
        banked = jnp.zeros_like(xs)

        def tick(carry, t):
            state, banked = carry
            inp = jnp.where(idx == 0, xs[jnp.clip(t, 0, M - 1)], state)
            out = stage_fn(local_layers, inp)
            m = t - (n_stages - 1)
            mc = jnp.clip(m, 0, M - 1)
            write = (idx == n_stages - 1) & (m >= 0)
            banked = banked.at[mc].set(jnp.where(write, out, banked[mc]))
            state = jax.lax.ppermute(out, AXIS_PIPE, perm)
            return (state, banked), None

        (_, banked), _ = jax.lax.scan(
            tick, (state, banked), jnp.arange(M + n_stages - 1))
        return jax.lax.psum(
            jnp.where(idx == n_stages - 1, banked, jnp.zeros_like(banked)),
            AXIS_PIPE,
        )

    def run_pipeline(stacked, xs):
        specs = _stacked_3d_specs(stacked)
        return jax.shard_map(
            pipelined, mesh=mesh,
            in_specs=(specs, P(None, AXIS_DATA)),
            out_specs=P(None, AXIS_DATA),
            check_vma=False,
        )(stacked, xs)

    def forward(pipe_params: Params, tokens: jax.Array) -> jax.Array:
        B, S = tokens.shape
        assert B % n_microbatches == 0, (B, n_microbatches)
        x = pipe_params["embed"][tokens]
        xs = x.reshape(n_microbatches, B // n_microbatches, S, -1)
        ys = run_pipeline(pipe_params["stacked"], xs).reshape(B, S, -1)
        ys = rms_norm(ys, pipe_params["final_norm"], cfg.norm_eps)
        return (ys @ pipe_params["lm_head"]).astype(jnp.float32)

    return forward


def pipeline_params_from_llama(params: Params, mesh: Optional[Mesh] = None,
                               tp: bool = False) -> Params:
    """Repack llama-style params (list-of-layer-dicts) for the pipeline:
    stack layers and, if a mesh is given, shard the stack over `pipe` (plus
    Megatron `model`-axis sharding when tp=True, for `make_llama_3d_forward`)."""
    stacked = stack_layer_params(params["layers"])
    if mesh is not None:
        if tp:
            specs = _stacked_3d_specs(stacked)
            stacked = jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                stacked, specs)
        else:
            stacked = shard_stacked_layers(stacked, mesh)
    return {
        "embed": params["embed"],
        "stacked": stacked,
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }
