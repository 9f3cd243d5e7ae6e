"""Targeted benchmark — the reference protocol script
(`/root/reference/benchmarks/targetted_bench.py`): B=4, S=4096, H=32, D=128,
forward-only, printing per-kernel latency and masked output checksums for the
three comparison kernels (ours / oracle-style XLA dense / cuDNN fused
attention).

Run on the GPU:  python benchmarks/targetted_bench.py
"""
from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")  # repo root

from bench import make_inputs  # noqa: E402
from fa2_jax import flash_attn_func  # noqa: E402
from fa2_jax.other_implementations import (  # noqa: E402
    cudnn_attention, xla_attention,
)
from fa2_jax.utils.benchmarking import device_time  # noqa: E402

BATCH = 4
SEQLEN = 4096
NUM_HEADS = 32
HEAD_DIM = 128
CAUSAL = False
DTYPE = jnp.bfloat16


def checksum(x):
    return float(jnp.sum(x.astype(jnp.float32)))


def main():
    q, k, v = make_inputs(BATCH, SEQLEN, SEQLEN, NUM_HEADS, NUM_HEADS, HEAD_DIM, DTYPE)
    flops = 4 * BATCH * NUM_HEADS * SEQLEN * SEQLEN * HEAD_DIM / (2 if CAUSAL else 1)

    kernels = {
        "ours": functools.partial(flash_attn_func, causal=CAUSAL),
        "xla-dense": functools.partial(xla_attention, causal=CAUSAL),
        "cudnn": functools.partial(cudnn_attention, causal=CAUSAL),
    }

    for name, fn in kernels.items():
        out = fn(q, k, v)
        t = device_time(fn, q, k, v)
        print(f"{name:14s}: {t*1e3:8.3f} ms  {flops/t/1e12:7.1f} TFLOP/s  "
              f"checksum={checksum(out):.6g}")


if __name__ == "__main__":
    main()
