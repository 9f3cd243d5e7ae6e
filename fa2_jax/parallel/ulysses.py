"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

The second sequence-parallel flavor next to `parallel/ring.py`. Where the
ring rotates KV chunks and merges partial softmax states hop by hop,
Ulysses re-shards: activations arrive sequence-sharded
[B, S/n, H, D]; one `all_to_all` per tensor turns them head-sharded
[B, S, H/n, D]; each device then runs the UNMODIFIED single-device flash
kernel over the full sequence for its head slice (causality, windows,
softcap — everything just works, no distributed softmax merge); the output
rides the inverse all-to-all back to sequence sharding.

Trade-off vs the ring (why both exist): Ulysses does 2 all-to-alls of
activation-sized tensors total (latency-friendly, link-efficient at moderate
n), but parallelism is capped by the head count (n must divide Hkv); the
ring scales past head count and keeps KV memory sharded, at the cost of n-1
hops. Both are exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
from jax.sharding import Mesh, PartitionSpec as P

from fa2_jax.ops.attention import flash_attn_func
from fa2_jax.parallel.mesh import AXIS_DATA, AXIS_SEQ


def make_ulysses_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    seq_axis: str = AXIS_SEQ,
):
    """Returns fn(q, k, v) on [B, S, H, D] arrays sharded
    P(data, seq, None, None); Hq and Hkv must be divisible by the seq-axis
    size. Exact (same numbers as the single-device kernel on the gathered
    arrays), differentiable (all-to-all transposes to all-to-all)."""
    n = int(mesh.shape[seq_axis])

    def head_to_seq(x):
        # [B, S/n, H, D] -> [B, S, H/n, D]: device j keeps head block j
        # (contiguous H/n heads) and gathers all sequence chunks, ordered by
        # source device = global sequence order.
        assert x.shape[2] % n == 0, (x.shape, n)
        return jax.lax.all_to_all(x, seq_axis, split_axis=2, concat_axis=1,
                                  tiled=True)

    def seq_to_head(x):
        # [B, S, H/n, D] -> [B, S/n, H, D]: inverse exchange; concat over
        # source device g rebuilds heads g-major (h = g * H/n + l).
        return jax.lax.all_to_all(x, seq_axis, split_axis=1, concat_axis=2,
                                  tiled=True)

    def local_fn(q, k, v):
        out = flash_attn_func(
            head_to_seq(q), head_to_seq(k), head_to_seq(v),
            causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, softcap=softcap,
        )
        return seq_to_head(out)

    spec = P(AXIS_DATA, seq_axis, None, None)
    return jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,  # pallas_call outputs cannot carry vma annotations
    )
