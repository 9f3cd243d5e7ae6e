"""Triple-run test core (reference `tests/core.py:10-78`): oracle fp32,
oracle low-precision + reordered ops (the error yardstick), and the Pallas
kernel under test, compared with FA-style relative tolerances."""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax import flash_attn_func, flash_attn_reference
from fa2_jax.utils.rng import dropout_keep_mask_reference
from tests.utils import compare_results_fa, generate_attention_mask, generate_test_data


def run_attention_case(
    batch_size: int,
    nheads_q: int,
    nheads_kv: int,
    seqlen_q: int,
    seqlen_k: int,
    head_dim: int,
    causal: bool,
    dropout_p: float = 0.0,
    use_attention_mask: bool = False,
    use_bias: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    dtype=jnp.bfloat16,
    forward_only: bool = False,
    seed: int = 0,
    verbose: bool = False,
):
    q, k, v, do = generate_test_data(
        batch_size, nheads_q, nheads_kv, seqlen_q, seqlen_k, head_dim, dtype, seed
    )
    attn_mask = (
        generate_attention_mask(batch_size, seqlen_q, seed) if use_attention_mask else None
    )
    rng = np.random.RandomState(seed + 77)
    attn_bias = (
        jnp.asarray(rng.rand(1, 1, seqlen_q, seqlen_k), dtype) if use_bias else None
    )
    dropout_seed = seed + 3
    dropout_mask = None
    if dropout_p > 0.0:
        dropout_mask = dropout_keep_mask_reference(
            dropout_seed, dropout_p, batch_size, nheads_q, seqlen_q, seqlen_k
        )

    def ref(q, k, v, upcast, reorder):
        return flash_attn_reference(
            q, k, v,
            query_padding_mask=attn_mask, key_padding_mask=attn_mask,
            attn_bias=attn_bias, dropout_p=dropout_p, dropout_mask=dropout_mask,
            causal=causal, window_size=window_size, softcap=softcap,
            upcast=upcast, reorder_ops=reorder,
        )

    def ours(q, k, v):
        return flash_attn_func(
            q, k, v, attention_mask=attn_mask, attention_bias=attn_bias,
            dropout_p=dropout_p, causal=causal, dropout_seed=dropout_seed,
            window_size=window_size, softcap=softcap,
        )

    out_ref, vjp_ref = jax.vjp(lambda *a: ref(*a, True, False), q, k, v)
    out_pt, vjp_pt = jax.vjp(lambda *a: ref(*a, False, True), q, k, v)
    out, vjp_ours = jax.vjp(ours, q, k, v)

    grads = None
    if not forward_only:
        grads = (vjp_ours(do), vjp_ref(do), vjp_pt(do))
    compare_results_fa(out, out_ref, out_pt, grads, verbose=verbose)
    return out, out_ref, out_pt
