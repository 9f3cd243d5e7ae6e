"""Block-sparse attention (`flash_attn_blocksparse_func`): the work-list
kernels driven by a static block mask — filtered (q, kv) block pairs never
enter the sequential grid. Parity vs a dense jnp oracle that applies the
expanded elementwise mask, including causal intersection, GQA, gradients,
and rows whose every block is masked out (zeros, lse -inf, zero grads)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax import flash_attn_blocksparse_func

BQ = BKV = 128


def _dense_oracle(q, k, v, block_mask, causal, scale):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    kx = jnp.repeat(k, g, axis=2)
    vx = jnp.repeat(v, g, axis=2)
    # precision='highest': on the GPU the default einsum runs TF32, which
    # would dominate the comparison (the kernels pin f32 dots to HIGHEST).
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, kx,
                        precision="highest").astype(jnp.float32) * scale
    m = np.zeros((S, S), bool)
    for i in range(S):
        for j in range(S):
            m[i, j] = bool(block_mask[i // BQ, j // BKV])
            if causal and j > i:
                m[i, j] = False
    keep = jnp.asarray(m)[None, None]
    scores = jnp.where(keep, scores, -jnp.inf)
    row_alive = jnp.any(keep, axis=-1, keepdims=True)
    p = jax.nn.softmax(scores, axis=-1)
    p = jnp.where(row_alive, p, 0.0)
    return jnp.einsum("bhqk,bkhd->bqhd", p, vx,
                      precision="highest").astype(q.dtype)


def _mk(B, S, Hq, Hkv, D, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, S, Hq, D), jnp.float32) * 0.5
    k = jax.random.normal(ks[1], (B, S, Hkv, D), jnp.float32) * 0.5
    v = jax.random.normal(ks[2], (B, S, Hkv, D), jnp.float32) * 0.5
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_blocksparse_matches_dense_oracle(causal):
    B, S, Hq, Hkv, D = 2, 512, 4, 2, 64
    nb = S // BQ
    rng = np.random.RandomState(0)
    mask = rng.rand(nb, nb) < 0.6
    mask[:, 0] = True          # every row keeps >= 1 block (non-causal)
    np.fill_diagonal(mask, True)   # ... and causally
    q, k, v = _mk(B, S, Hq, Hkv, D)
    out = flash_attn_blocksparse_func(
        q, k, v, mask, causal=causal, block_q=BQ, block_kv=BKV)
    ref = _dense_oracle(q, k, v, mask, causal, D ** -0.5)
    assert float(jnp.abs(out - ref).max()) < 1e-4


def test_blocksparse_empty_rows_and_lse():
    """A q block with every kv block masked out: zeros, lse=-inf, and its
    incoming cotangent contributes nothing."""
    B, S, Hq, Hkv, D = 1, 512, 2, 2, 64
    nb = S // BQ
    mask = np.ones((nb, nb), bool)
    mask[1, :] = False
    q, k, v = _mk(B, S, Hq, Hkv, D, seed=2)

    out, lse = flash_attn_blocksparse_func(
        q, k, v, mask, block_q=BQ, block_kv=BKV, return_lse=True)
    assert float(jnp.abs(out[:, BQ:2 * BQ]).max()) == 0.0
    assert bool(jnp.all(lse[:, :, BQ:2 * BQ] == -jnp.inf))
    assert bool(jnp.all(jnp.isfinite(lse[:, :, :BQ])))

    def loss(q, k, v):
        o = flash_attn_blocksparse_func(
            q, k, v, mask, block_q=BQ, block_kv=BKV)
        return (o.astype(jnp.float32) ** 2).sum()

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    assert float(jnp.abs(dq[:, BQ:2 * BQ]).max()) == 0.0
    assert bool(jnp.all(jnp.isfinite(dq))) and bool(jnp.all(jnp.isfinite(dk)))


def test_blocksparse_grads_match_oracle():
    B, S, Hq, Hkv, D = 1, 384, 2, 1, 64
    nb = S // BQ
    mask = np.tril(np.ones((nb, nb), bool))       # block-causal pattern
    mask[2, 0] = False                            # plus a hole
    q, k, v = _mk(B, S, Hq, Hkv, D, seed=3)
    ks = jax.random.split(jax.random.PRNGKey(9), 1)
    do = jax.random.normal(ks[0], q.shape, jnp.float32) * 0.5

    out, vjp = jax.vjp(
        lambda q, k, v: flash_attn_blocksparse_func(
            q, k, v, mask, block_q=BQ, block_kv=BKV), q, k, v)
    ref, vjp_ref = jax.vjp(
        lambda q, k, v: _dense_oracle(q, k, v, mask, False, D ** -0.5),
        q, k, v)
    assert float(jnp.abs(out - ref).max()) < 1e-4
    for g, gr, name in zip(vjp(do), vjp_ref(do), ("dq", "dk", "dv")):
        assert float(jnp.abs(g - gr).max()) < 2e-4, name


def test_blocksparse_cost_scales_with_live_blocks():
    """The index lists contain exactly the live pairs — the point of the
    per-program list design."""
    from fa2_jax.ops.varlen import _build_schedule

    nb = 8
    mask = np.eye(nb, dtype=bool)      # diagonal-only: nb live pairs
    meta, lists = _build_schedule(
        [0], [nb * BQ], [nb * BQ], [nb * BQ], BQ, BKV, False,
        keep_block=lambda s, jq, jk: bool(mask[jq, jk]))
    assert int(meta[:, 4].sum()) == nb  # one entry per live pair
    assert lists.shape == (nb, 1)
    assert list(lists[:, 0]) == list(range(nb))
    meta, _ = _build_schedule([0], [nb * BQ], [nb * BQ], [nb * BQ],
                              BQ, BKV, False)
    assert int(meta[:, 4].sum()) == nb * nb
