"""Sliding-window and softcap support IN THE KERNELS — the reference only has
these in its oracle (`src/reference_implementation.py:8-35,87-90`; declared
kernel TODOs at `tests/test_fwd_bwd.py:7-8` there)."""
import pytest

from tests.core import run_attention_case


@pytest.mark.parametrize("window_size", [(32, 0), (0, 16)])
def test_sliding_window(window_size):
    run_attention_case(2, 4, 2, 255, 255, 64, causal=False, window_size=window_size)


def test_sliding_window_causal():
    run_attention_case(2, 4, 2, 255, 255, 64, causal=True, window_size=(64, -1))


@pytest.mark.parametrize("softcap", [30.0, 5.0])
def test_softcap(softcap):
    run_attention_case(2, 4, 2, 128, 128, 64, causal=True, softcap=softcap)


def test_softcap_with_bias():
    run_attention_case(2, 4, 2, 128, 128, 64, causal=False, softcap=20.0, use_bias=True)


def test_softcap_causal_fast_path_shapes():
    """Regression: causal+softcap once routed to fast kernels that silently
    DROPPED the tanh; a multi-block causal shape with a biting softcap must
    match the oracle."""
    run_attention_case(2, 4, 2, 256, 256, 128, causal=True, softcap=5.0)


def test_block_sizes_always_lane_aligned():
    """The GPU block rule: every block is a power of two, at least 16, never
    larger than the (power-of-two-rounded) sequence, and odd seqlens pad to
    a multiple of every block of their axis."""
    from fa2_jax.ops.tuning import choose_block_sizes
    from fa2_jax.utils import round_up_to_multiple

    for sq, sk in [(4700, 3000), (3000, 4700), (2900, 2900), (1, 1),
                   (130, 131), (8192, 640), (17, 9)]:
        for d in (16, 64, 128, 256):
            for bits in (16, 32):
                bs = choose_block_sizes(sq, sk, d, dtype_bits=bits)
                for v, s in ((bs.block_q, sq), (bs.block_kv, sk),
                             (bs.block_q_bwd, sq), (bs.block_kv_bwd, sk)):
                    assert v >= 16 and v & (v - 1) == 0, (sq, sk, d, bs)
                    assert v <= max(16, 1 << (s - 1).bit_length()), (sq, sk, bs)
                sqp = round_up_to_multiple(sq, bs.q_multiple)
                skp = round_up_to_multiple(sk, bs.kv_multiple)
                assert sqp % bs.block_q == 0 and sqp % bs.block_q_bwd == 0
                assert skp % bs.block_kv == 0 and skp % bs.block_kv_bwd == 0


def test_decode_attention_odd_cache_extent():
    """Regression: S_max that is not a multiple of the requested block must
    shrink the block, not assert (e.g. S_max=640 with block 256)."""
    import jax.numpy as jnp
    import numpy as np
    from fa2_jax.ops.decode import decode_attention

    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.normal(0, 0.5, (2, 4, 128)), jnp.float32)
    k = jnp.asarray(rng.normal(0, 0.5, (2, 2, 640, 128)), jnp.float32)
    v = jnp.asarray(rng.normal(0, 0.5, (2, 2, 640, 128)), jnp.float32)
    lens = jnp.asarray([640, 200], jnp.int32)
    out = decode_attention(q, k, v, lens, block_kv=256)  # 640 % 256 -> shrink
    assert out.shape == (2, 4, 128)
    assert bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.parametrize("window_size,causal", [
    ((256, 0), True),     # Mistral-style causal sliding window
    ((256, -1), False),   # left-only, non-causal
    ((192, 64), False),   # two-sided
])
def test_banded_window_kernel_parity(window_size, causal):
    """The kernel visits only the KV blocks inside each row block's window
    (blocks left or right of it are never read): small blocks put several
    whole blocks OUTSIDE the window, and the result must still match the
    oracle at float32."""
    import jax
    import jax.numpy as jnp

    from fa2_jax import flash_attn_reference
    from fa2_jax.ops.flash_fwd import flash_attn_forward
    from tests.utils import generate_test_data

    B, Hq, Hkv, S, D = 1, 4, 2, 1024, 64
    q, k, v, _ = generate_test_data(B, Hq, Hkv, S, S, D, jnp.float32)
    qT, kT, vT = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    lens = jnp.broadcast_to(jnp.array([[S, S]], jnp.int32), (B, 2))
    scal = jnp.array([[0, 0, 0, 0]], jnp.int32)
    o, lse = flash_attn_forward(
        qT, kT, vT, lens, scal, None, causal=causal,
        softmax_scale=D ** -0.5, window=window_size,
        block_q=128, block_kv=64, seqlen_q_real=S, seqlen_k_real=S)
    with jax.default_matmul_precision("highest"):
        o_ref, lse_ref = flash_attn_reference(
            q, k, v, causal=causal, window_size=window_size, return_lse=True)
    assert float(jnp.max(jnp.abs(jnp.swapaxes(o, 1, 2) - o_ref))) < 1e-5
    fin = jnp.isfinite(lse_ref)
    assert bool(jnp.all(fin == jnp.isfinite(lse[..., 0])))
    assert float(jnp.max(jnp.abs(jnp.where(fin, lse[..., 0] - lse_ref,
                                           0.0)))) < 1e-5
