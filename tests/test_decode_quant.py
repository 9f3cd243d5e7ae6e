"""Decode-attention kernel + quantized KV cache numerics.

Quantized parity follows BASELINE.md's bit-width-matched rule: the kernel's
fused-dequant output is compared against the oracle running on explicitly
dequantized K/V (identical quantization error in both), so the tolerance is
the kernel tolerance, not the quantization error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.ops.decode import decode_attention
from fa2_jax.ops.quant import dequantize_tensor, quantize_tensor
from fa2_jax.ops.reference import flash_attn_reference


def _setup(B=3, Hq=8, Hkv=2, S_max=256, D=128, seed=0):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.normal(0, 0.5, (B, Hq, D)), jnp.float32)
    k = jnp.asarray(rng.normal(0, 0.5, (B, Hkv, S_max, D)), jnp.float32)
    v = jnp.asarray(rng.normal(0, 0.5, (B, Hkv, S_max, D)), jnp.float32)
    lens = jnp.asarray(rng.randint(3, S_max + 1, size=(B,)), jnp.int32)
    return q, k, v, lens


def _oracle(q, k, v, lens):
    """Dense reference: per-sequence key-padding to lens."""
    B, Hq, D = q.shape
    S_max = k.shape[2]
    mask = jnp.arange(S_max)[None, :] < lens[:, None]
    out = flash_attn_reference(
        q[:, None],                      # [B, 1, Hq, D]
        jnp.transpose(k, (0, 2, 1, 3)),  # [B, S, Hkv, D]
        jnp.transpose(v, (0, 2, 1, 3)),
        key_padding_mask=mask,
    )
    return out[:, 0]


@pytest.mark.parametrize("block_kv", [128, 256])
def test_decode_attention_bf16_cache(block_kv):
    q, k, v, lens = _setup()
    out = decode_attention(q, k, v, lens, block_kv=block_kv)
    ref = _oracle(q, k, v, lens)
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-5


def test_decode_attention_ragged_short_lens():
    q, k, v, lens = _setup()
    lens = jnp.asarray([1, 129, 256], jnp.int32)
    out = decode_attention(q, k, v, lens, block_kv=128)
    ref = _oracle(q, k, v, lens)
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-5


@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_decode_attention_quantized(qdtype):
    q, k, v, lens = _setup()
    kq, ks = quantize_tensor(k, qdtype)
    vq, vs = quantize_tensor(v, qdtype)
    # Kernel takes scales transposed: [B, H, S, 1] -> [B, H, 1, S].
    out = decode_attention(q, kq, vq, lens,
                           jnp.swapaxes(ks, 2, 3), jnp.swapaxes(vs, 2, 3),
                           block_kv=128)
    # Matched bit-width oracle: dense attention over the dequantized cache.
    kd = dequantize_tensor(kq, ks)
    vd = dequantize_tensor(vq, vs)
    ref = _oracle(q, kd, vd, lens)
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-5


def test_quantize_roundtrip_error():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.normal(0, 0.5, (2, 4, 64, 128)), jnp.float32)
    for qdtype, tol in [(jnp.int8, 0.02), (jnp.float8_e4m3fn, 0.15)]:
        vals, scales = quantize_tensor(x, qdtype)
        err = jnp.max(jnp.abs(dequantize_tensor(vals, scales) - x))
        rel = float(err) / 0.5
        assert rel < tol, (qdtype, rel)
