"""Sharded attention: head-tensor-parallel + data-parallel via shard_map.

The Pallas grid already treats (batch, head) as embarrassingly parallel
dimensions, so multi-chip TP/DP is a `shard_map` that hands each device its
(batch shard, head shard) and runs the SAME kernel per shard — in place of
the NCCL-style kernels the reference never had (SURVEY.md §2.4:
"TP over KV heads [is] the natural GQA axis the kernels already index").
No collectives are needed in attention itself; the surrounding projections
reduce over `model` (psum in the wo/w_down matmuls, inserted by GSPMD).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

from fa2_jax.ops.attention import flash_attn_func
from fa2_jax.parallel.mesh import AXIS_DATA, AXIS_MODEL


def make_tp_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
):
    """Returns fn(q, k, v) with q [B, Sq, Hq, D] sharded (data, None, model),
    k/v likewise over KV heads. Requires Hq and Hkv divisible by the model
    axis so every shard keeps whole GQA groups."""

    def local_fn(q, k, v):
        return flash_attn_func(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, softcap=softcap,
        )

    spec = P(AXIS_DATA, None, AXIS_MODEL, None)
    return jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,  # pallas_call outputs cannot carry vma annotations
    )
