"""Compiled-kernel tests: the Triton kernels as the GPU compiles them,
against the oracle. Marked `gpu`: they skip on the CPU (where the same
kernels run interpreted in the rest of the suite) and run on the card with
`pytest -m gpu` or `python chip_smoke.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.core import run_attention_case

pytestmark = pytest.mark.gpu


def test_kernels_compile_for_gpu():
    from fa2_jax.utils import use_interpreter

    assert jax.default_backend() == "gpu"
    assert use_interpreter() is False


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, seqlen_q=200, seqlen_k=333),
    dict(causal=True, dropout_p=0.1), dict(causal=False, use_bias=True),
    dict(causal=True, window_size=(64, 0), softcap=20.0),
    dict(causal=True, use_attention_mask=True),
    dict(causal=True, dtype=jnp.float16),
])
def test_flash_compiled_matches_oracle(case):
    case = dict(case)
    sq = case.pop("seqlen_q", 384)
    sk = case.pop("seqlen_k", sq)
    run_attention_case(2, 8, 2, sq, sk, 128, **case)


@pytest.mark.parametrize("qdtype", [None, jnp.int8, jnp.float8_e4m3fn])
def test_decode_compiled_matches_oracle(qdtype):
    from fa2_jax import flash_attn_reference
    from fa2_jax.ops.decode import decode_attention
    from fa2_jax.ops.quant import quantize_tensor

    B, Hq, Hkv, S, D = 4, 16, 4, 1024, 128
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.normal(0, 0.5, (B, Hq, D)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(0, 0.5, (B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(0, 0.5, (B, Hkv, S, D)), jnp.bfloat16)
    lens = jnp.asarray([1, 300, 777, 1024], jnp.int32)
    ksc = vsc = None
    if qdtype is not None:
        k, ksc = quantize_tensor(k, qdtype)
        v, vsc = quantize_tensor(v, qdtype)
        kd, vd = k.astype(jnp.float32) * ksc, v.astype(jnp.float32) * vsc
        ksc, vsc = jnp.swapaxes(ksc, 2, 3), jnp.swapaxes(vsc, 2, 3)
    else:
        kd, vd = k.astype(jnp.float32), v.astype(jnp.float32)
    out = decode_attention(q, k, v, lens, ksc, vsc)
    with jax.default_matmul_precision("highest"):
        ref = flash_attn_reference(
            q[:, None].astype(jnp.float32), jnp.swapaxes(kd, 1, 2),
            jnp.swapaxes(vd, 1, 2),
            key_padding_mask=jnp.arange(S)[None] < lens[:, None])[:, 0]
    assert float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref))) < 2e-2


def test_varlen_compiled_matches_dense():
    from fa2_jax import flash_attn_func, flash_attn_varlen_func
    from fa2_jax import pack_padded_batch, unpack_padded_batch
    from tests.utils import generate_test_data

    lens = (300, 512, 129)
    q, k, v, _ = generate_test_data(3, 4, 2, 512, 512, 64, jnp.bfloat16)
    (qp, kp, vp), starts, T = pack_padded_batch([q, k, v], lens)
    out = flash_attn_varlen_func(qp, kp, vp, list(starts) + [T],
                                 seqlens=lens, causal=True)
    out = unpack_padded_batch(out, starts, lens, 512)
    mask = jnp.arange(512)[None] < jnp.asarray(lens)[:, None]
    dense = flash_attn_func(q, k, v, attention_mask=mask, causal=True)
    err = jnp.abs(out.astype(jnp.float32) - dense.astype(jnp.float32))
    assert float(jnp.max(jnp.where(mask[:, :, None, None], err, 0.0))) < 2e-2
