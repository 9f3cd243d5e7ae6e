"""Paged KV cache: block-table decode parity with the dense oracle, page
allocator bookkeeping, and quantized pool storage."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.ops.decode import paged_decode_attention
from fa2_jax.ops.reference import flash_attn_reference
from fa2_jax.runtime.paged_cache import PagedCacheConfig, PagedKVCache


def _dense_oracle(q, k_bhsd, v_bhsd, lens):
    S_max = k_bhsd.shape[2]
    mask = jnp.arange(S_max)[None, :] < lens[:, None]
    out = flash_attn_reference(
        q[:, None],
        jnp.transpose(k_bhsd, (0, 2, 1, 3)),
        jnp.transpose(v_bhsd, (0, 2, 1, 3)),
        key_padding_mask=mask,
    )
    return out[:, 0]


@pytest.mark.parametrize("qdtype", [None, jnp.int8])
def test_paged_decode_matches_dense(qdtype):
    """Tokens written through scattered pages must attend identically to a
    contiguous cache (same data, shuffled physical pages)."""
    B, Hq, Hkv, D, page, S = 3, 8, 2, 128, 128, 512
    cfg = PagedCacheConfig(
        n_layers=1, n_kv_heads=Hkv, head_dim=D, page_size=page,
        n_pages=B * (S // page) + 3, n_slots=B, max_seq=S, qdtype=qdtype,
        compute_dtype=jnp.float32,
    )
    cache = PagedKVCache(cfg)
    rng = np.random.RandomState(0)
    lens = jnp.asarray([S, 130, 37], jnp.int32)
    k = jnp.asarray(rng.normal(0, 0.5, (B, S, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.normal(0, 0.5, (B, S, Hkv, D)), jnp.float32)
    q = jnp.asarray(rng.normal(0, 0.5, (B, Hq, D)), jnp.float32)

    # Every slot writes the full S tokens (positions past its len are
    # masked at read time); two chunks of different sizes exercise
    # page-crossing offsets.
    for b in range(B):
        cache.ensure_capacity(b, S)
    cut = 128
    cache.write_tokens(0, k[:, :cut], v[:, :cut], jnp.zeros((B,), jnp.int32))
    cache.write_tokens(0, k[:, cut:], v[:, cut:],
                       jnp.full((B,), cut, jnp.int32))

    out = cache.attention(0, q, lens)
    if qdtype is None:
        ref = _dense_oracle(q, jnp.transpose(k, (0, 2, 1, 3)),
                            jnp.transpose(v, (0, 2, 1, 3)), lens)
        tol = 2e-5
    else:
        # Matched bit-width: oracle on the dequantized pool contents.
        from fa2_jax.ops.quant import dequantize_tensor, quantize_tensor
        kq, ks = quantize_tensor(jnp.transpose(k, (0, 2, 1, 3)), qdtype)
        vq, vs = quantize_tensor(jnp.transpose(v, (0, 2, 1, 3)), qdtype)
        ref = _dense_oracle(q, dequantize_tensor(kq, ks),
                            dequantize_tensor(vq, vs), lens)
        tol = 2e-5
    err = float(jnp.max(jnp.abs(out - ref)))
    assert err < tol, err


def test_page_allocator_reuse_and_exhaustion():
    cfg = PagedCacheConfig(
        n_layers=1, n_kv_heads=1, head_dim=128, page_size=128,
        n_pages=4, n_slots=2, max_seq=256, compute_dtype=jnp.float32,
    )
    cache = PagedKVCache(cfg)
    assert cache.free_pages == 3  # page 0 reserved
    cache.ensure_capacity(0, 200)  # 2 pages
    cache.ensure_capacity(1, 100)  # 1 page
    assert cache.free_pages == 0
    with pytest.raises(MemoryError):
        cache.ensure_capacity(1, 200)
    t = np.asarray(cache.tables_device())
    assert len({t[0, 0], t[0, 1], t[1, 0]}) == 3  # distinct physical pages
    cache.release(0)
    assert cache.free_pages == 2
    cache.ensure_capacity(1, 256)  # reuses freed pages
    assert cache.free_pages == 1
