"""Shared numeric / shape helpers and the kernel route.

This plays the role of the host-side helpers in the reference
(`/root/reference/src/utils.py`): padding/alignment utilities used by the
kernel callers, and the one place that decides how a Pallas kernel runs on
the current backend (`kernel_call`).
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# log2(e): all kernels work in the base-2 exponent domain so they can use
# exp2 directly. The stored logsumexp is therefore in log-base-2 units, the
# same contract as the reference (`src/forward/kernel.py:119`,
# `tests/test_logsumexp.py:74`).
LOG2E = 1.44269504088896340736

# Finite large-negative used to mask attention scores. Finite (not -inf) so
# `m - m` style subtractions can never produce NaN inside the online softmax.
MASK_VALUE = -0.98 * float(jnp.finfo(jnp.float32).max)
NEG_INF = float("-inf")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))


def pad_to_multiple(x: jax.Array, multiple: int, axis: int) -> jax.Array:
    """Zero-pad `x` along `axis` up to the next multiple of `multiple`."""
    size = x.shape[axis]
    target = round_up_to_multiple(size, multiple)
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return jnp.pad(x, pad)


def default_softmax_scale(head_dim: int) -> float:
    """Default pre-softmax scale, matching `src/forward/caller.py:42`."""
    return 1.0 / math.sqrt(head_dim)


def head_dim_padded(head_dim: int) -> int:
    """Kernel head dim: a power of two, at least 16 (Triton block shapes
    are powers of two and `tl.dot` needs K >= 16)."""
    return max(16, next_power_of_2(head_dim))


def use_interpreter(platform: Optional[str] = None) -> bool:
    """The kernel route for `platform` (default: JAX's default backend).

    Compiled Triton on "gpu"; the Pallas interpreter only on "cpu" (the
    tests). Any other backend has no route, and silently interpreting there
    would hide that, so it raises."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: kernels compile "
        "through Triton on 'gpu' and run interpreted on 'cpu'")


def kernel_call(kernel, *, name: str, num_warps: int = 4,
                num_stages: int = 2, **kwargs):
    """`pl.pallas_call` on the Triton route, compiled or interpreted as
    `use_interpreter` decides."""
    return pl.pallas_call(
        kernel,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=use_interpreter(),
        name=name,
        **kwargs,
    )


def dot_precision(*operands):
    """Matmul precision for kernel dots: fp32 operands multiply at true fp32
    (`DEFAULT` would run them as TF32, ~1e-3 relative error, and the fp32
    path exists to validate against the fp32 oracle); bf16/fp16 operands keep
    the default tensor-core path."""
    if any(o.dtype == jnp.float32 for o in operands):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `$JAX_COMPILATION_CACHE_DIR`, when set, is used as it is (JAX reads it
    itself). Otherwise the cache lives at a fixed `<repo>/.jax_cache`: the
    path is part of the cache key, so a directory that moves never hits."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
