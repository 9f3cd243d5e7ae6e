"""Device-mesh helpers.

The reference has no distributed layer at all (SURVEY.md §2.4); this is the
scale-out surface: a named `jax.sharding.Mesh` with the canonical
axes
    data  — batch (DP)
    model — attention heads / MLP hidden (TP)
    seq   — sequence (ring/context parallelism)
and PartitionSpec builders for the model's parameter/activation pytrees.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    pipe: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Named mesh over (data, model, seq) — plus a leading `pipe` axis when
    pipeline parallelism is requested. `pipe` comes FIRST (slowest-varying
    devices): stage-boundary ppermutes move one activation per microbatch
    and tolerate DCN latency, while `model`/`seq` collectives fire per layer
    and must stay on the fastest-linked device groups. The axis is
    only materialized when pipe > 1 so existing 3-axis consumers (serving's
    axis scan, sharding tables) see an unchanged mesh otherwise."""
    devices = list(devices if devices is not None else jax.devices())
    need = data * model * seq * pipe
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    if pipe > 1:
        arr = np.array(devices[:need]).reshape(pipe, data, model, seq)
        return Mesh(arr, (AXIS_PIPE, AXIS_DATA, AXIS_MODEL, AXIS_SEQ))
    arr = np.array(devices[:need]).reshape(data, model, seq)
    return Mesh(arr, (AXIS_DATA, AXIS_MODEL, AXIS_SEQ))


def make_multihost_mesh(model: int = 1, seq: int = 1) -> Mesh:
    """Mesh for a multi-host deployment (after `jax.distributed.initialize`).

    Axis-to-fabric layout follows the bandwidth hierarchy: `data` (gradient
    all-reduce, latency-tolerant, overlappable) spans hosts — riding DCN
    when the slice boundary is crossed — while `model` (per-layer psum) and
    `seq` (per-step ppermute) stay INSIDE a host's devices so their
    collectives ride the host's own links (NVLink). `jax.sharding.Mesh` maps the LAST mesh axes to
    the fastest-varying device order, and `jax.devices()` enumerates
    process-local devices contiguously, so putting `data` first achieves
    exactly that placement — no explicit device permutation needed.

    On this single-host harness the same construction degenerates to
    `make_mesh` over local devices (validated by the virtual-device suite).
    """
    devices = jax.devices()
    per_host = model * seq
    n_local = jax.local_device_count()
    assert n_local % per_host == 0, (
        f"model*seq = {per_host} must divide the {n_local} devices per host "
        "so TP/SP collectives never cross DCN")
    data = len(devices) // per_host
    return make_mesh(data=data, model=model, seq=seq, devices=devices)


_TP_TABLE = {
    "wq": P(None, AXIS_MODEL),
    "wk": P(None, AXIS_MODEL),
    "wv": P(None, AXIS_MODEL),
    "wo": P(AXIS_MODEL, None),
    # Qwen2-style qkv biases: 1-D [n_heads*hd], sharded over heads like the
    # matching projection's output dim.
    "bq": P(AXIS_MODEL),
    "bk": P(AXIS_MODEL),
    "bv": P(AXIS_MODEL),
    "w_gate": P(None, AXIS_MODEL),
    "w_up": P(None, AXIS_MODEL),
    "w_down": P(AXIS_MODEL, None),
    "embed": P(None, None),
}


def _spec_from_path(path, table) -> P:
    """Spec for a leaf; quantized weights ({'qvalues','qscale'} sub-dicts,
    `ops/quant.py`) inherit the parent weight's spec — qvalues shard like the
    weight, the [1, out] qscale row shards only along the output dim."""
    names = [p.key if hasattr(p, "key") else str(p) for p in path]
    name = names[-1]
    if name in ("qvalues", "qscale") and len(names) >= 2:
        wspec = table.get(names[-2], P())
        if name == "qvalues":
            return wspec
        out_axis = wspec[1] if len(wspec) > 1 else None
        return P(None, out_axis)
    return table.get(name, P())


def param_pspecs(params) -> dict:
    """PartitionSpecs for the LLaMA param pytree: TP over heads/hidden.

    wq/wk/wv shard output dim (heads) over `model`; wo shards input dim;
    w_gate/w_up shard hidden; w_down shards input hidden; embeddings/norms
    replicated.
    """
    table = dict(_TP_TABLE, lm_head=P(None, AXIS_MODEL))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _spec_from_path(path, table), params
    )


def serving_param_pspecs(params) -> dict:
    """TP specs for INFERENCE (the serving Engine): like `param_pspecs`, but
    lm_head is replicated — greedy decode argmaxes over the full vocab row on
    every shard, so logits come out replicated with no gather."""
    table = dict(_TP_TABLE, lm_head=P(None, None))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _spec_from_path(path, table), params
    )


def shard_params(params, mesh: Mesh, specs=None):
    specs = param_pspecs(params) if specs is None else specs
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs
    )


def fsdp_param_pspecs(params, mesh: Optional[Mesh] = None,
                      axis: str = AXIS_DATA, min_size: int = 2 ** 14):
    """ZeRO-3 / FSDP-style PartitionSpecs: every large weight shards one dim
    over the `data` axis, so parameters, gradients, AND optimizer state live
    sharded (each device stores 1/dp of them). Under `jit` the partitioner
    materializes the standard FSDP schedule from these annotations alone:
    all-gather a layer's weights right before use, reduce-scatter its grads
    — the scaling-book recipe, no hand-written collectives.

    The sharded dim is the largest one divisible by the axis size (pass
    `mesh` to honor divisibility; replicates when none divides); small
    leaves (norms, scalars) stay replicated — sharding them costs more in
    collective latency than the bytes saved.

    COMPOSES with tensor parallelism: when the mesh has a `model` axis > 1,
    each weight keeps its Megatron spec (`_TP_TABLE`) and the data axis
    shards a remaining free dim — ZeRO-3 over the TP shards, not instead of
    them.
    """
    n = int(mesh.shape[axis]) if mesh is not None else None
    tp = int(mesh.shape.get(AXIS_MODEL, 1)) if mesh is not None else 1
    tp_table = dict(_TP_TABLE, lm_head=P(None, AXIS_MODEL)) if tp > 1 else {}

    def spec(path, leaf):
        base = _spec_from_path(path, tp_table) if tp > 1 else P()
        if leaf.ndim < 1 or leaf.size < min_size:
            return base
        dims = sorted(range(leaf.ndim), key=lambda d: -leaf.shape[d])
        for d in dims:
            if len(base) > d and base[d] is not None:
                continue  # dim already TP-sharded
            # Divisibility applies to the LOCAL (TP-sharded leaf) extent,
            # which equals the global extent on non-TP dims.
            if n is None or leaf.shape[d] % n == 0:
                out = [base[i] if i < len(base) else None
                       for i in range(leaf.ndim)]
                out[d] = axis
                return P(*out)
        return base

    return jax.tree_util.tree_map_with_path(spec, params)
