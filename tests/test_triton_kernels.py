"""The Triton-route kernels on small shapes (interpreted on the CPU), and what
surrounds them: block ranges, the kernel route, CUDA lowering, peaks, the
compile cache and the NumPy checkpoint."""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax import flash_attn_func, flash_attn_reference
from fa2_jax.ops.tuning import BlockSizes
from fa2_jax.utils.rng import dropout_keep_mask_reference

SMALL = BlockSizes(block_q=32, block_kv=16, block_q_bwd=16, block_kv_bwd=32)


def _err(a, b):
    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                 - jnp.asarray(b, jnp.float32))))


@pytest.mark.parametrize("sq,sk,hq,hkv,kw", [
    (96, 96, 2, 2, dict(causal=True)),                  # many causal blocks
    (48, 112, 2, 2, dict(causal=True)),                 # Sk > Sq shift
    (112, 48, 2, 2, dict(causal=True)),                 # Sq > Sk: dead rows
    (80, 80, 8, 2, dict(causal=True)),                  # GQA group 4
    (64, 64, 2, 2, dict(causal=True, dropout_p=0.2)),   # dropout
    (64, 64, 2, 2, dict(causal=True, lse=True)),        # dlse gradient
    (96, 96, 2, 1, dict(window_size=(24, 8))),          # two-sided window
    (70, 70, 2, 2, dict(causal=False)),                 # padded tail
    (64, 80, 4, 2, dict(bias=True)),                    # broadcast bias + dbias
    (64, 64, 2, 2, dict(causal=True, mask=True)),       # per-batch lengths
])
def test_flash_fwd_bwd_small_blocks(sq, sk, hq, hkv, kw):
    kw = dict(kw)
    lse, use_bias, use_mask = (kw.pop(n, False) for n in ("lse", "bias", "mask"))
    p = kw.get("dropout_p", 0.0)
    B, D = 2, 32
    ks = jax.random.split(jax.random.PRNGKey(sq * 7 + sk), 6)
    q = jax.random.normal(ks[0], (B, sq, hq, D)) * 0.5
    k = jax.random.normal(ks[1], (B, sk, hkv, D)) * 0.5
    v = jax.random.normal(ks[2], (B, sk, hkv, D)) * 0.5
    do = jax.random.normal(ks[3], (B, sq, hq, D))
    dlse = jax.random.normal(ks[4], (B, hq, sq))
    bias = jax.random.normal(ks[5], (1, hq, sq, sk)) if use_bias else None
    mask = (jnp.arange(sq)[None] < jnp.asarray([sq, sq - 21])[:, None]
            if use_mask else None)
    keep = dropout_keep_mask_reference(5, p, B, hq, sq, sk) if p else None

    def loss(out):
        o, l = out
        val = jnp.sum(o * do)
        return val + (jnp.sum(jnp.where(jnp.isfinite(l), l, 0.0) * dlse)
                      if lse else 0.0)

    def ours(q, k, v, b):
        return loss(flash_attn_func(
            q, k, v, attention_mask=mask, attention_bias=b, dropout_seed=5,
            block_sizes=SMALL, return_lse=True, **kw))

    def ref(q, k, v, b):
        return loss(flash_attn_reference(
            q, k, v, query_padding_mask=mask, key_padding_mask=mask,
            attn_bias=b, dropout_mask=keep, return_lse=True, **kw))

    argnums = (0, 1, 2, 3) if use_bias else (0, 1, 2)
    g = jax.grad(ours, argnums)(q, k, v, bias)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(ref, argnums)(q, k, v, bias)
        assert abs(float(ours(q, k, v, bias) - ref(q, k, v, bias))) < 1e-3
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), g, g_ref):
        assert _err(a, b) < 1e-4, (name, _err(a, b))


def _brute_ranges(rows, cols, q_len, kv_len, causal, window, block):
    """Blocks (along cols) that hold any valid pair, and those where every
    (row, col) pair is valid."""
    shift = kv_len - q_len
    r = np.asarray(rows)[:, None]
    c = np.asarray(cols)[None, :]
    keep = (c < kv_len) & (r < q_len)
    if causal or window[1] >= 0:
        keep &= c <= r + shift + (0 if causal else window[1])
    if window[0] >= 0:
        keep &= c >= r + shift - window[0]
    blocks = keep.reshape(len(rows), -1, block)
    return (set(np.nonzero(blocks.any(axis=(0, 2)))[0]),
            set(np.nonzero(blocks.all(axis=(0, 2)))[0]))


@pytest.mark.parametrize("q_len,kv_len,causal,window", [
    (64, 64, True, (-1, -1)), (40, 64, True, (-1, -1)),
    (64, 40, False, (10, 3)), (64, 64, False, (-1, 0)),
])
def test_block_ranges_match_brute_force(q_len, kv_len, causal, window):
    from fa2_jax.ops.flash_bwd import q_block_range
    from fa2_jax.ops.flash_fwd import kv_block_range

    bq = bk = 8
    for i in range(64 // bq):
        rows = range(i * bq, (i + 1) * bq)
        need, full = _brute_ranges(rows, range(64), q_len, kv_len, causal,
                                   window, bk)
        lo, flo, fhi, hi = (int(x) for x in kv_block_range(
            rows[0], rows[-1], q_len=q_len, kv_len=kv_len, kv_off=0,
            block_kv=bk, num_kv_blocks=64 // bk, causal=causal, window=window))
        assert need <= set(range(lo, hi)), (i, need, lo, hi)
        assert set(range(flo, fhi)) <= full, (i, full, flo, fhi)
        # Only rows that exist need columns: the masked edges stay narrow.
        if need and q_len > rows[-1]:
            assert min(need) == lo and max(need) == hi - 1
    for j in range(64 // bk):
        cols = range(j * bk, (j + 1) * bk)
        lo, flo, fhi, hi = (int(x) for x in q_block_range(
            cols[0], cols[-1], q_len=q_len, kv_len=kv_len, q_off=0,
            block_q=bq, num_q_blocks=64 // bq, causal=causal, window=window))
        rows_ok = {i for i in range(64 // bq)
                   if _brute_ranges(range(i * bq, (i + 1) * bq), cols, q_len,
                                    kv_len, causal, window, bk)[0]}
        assert rows_ok <= set(range(lo, hi)), (j, rows_ok, lo, hi)


def _decode_oracle(q, kd, vd, lens, window_left=-1, softcap=0.0):
    S = kd.shape[2]
    pos = jnp.arange(S)[None]
    mask = pos < lens[:, None]
    if window_left >= 0:
        mask &= pos >= lens[:, None] - 1 - window_left
    with jax.default_matmul_precision("highest"):
        return flash_attn_reference(
            q[:, None], jnp.swapaxes(kd, 1, 2), jnp.swapaxes(vd, 1, 2),
            key_padding_mask=mask, softcap=softcap)[:, 0]


def _cache(qdtype, B=3, Hkv=2, S=128, D=32, seed=0):
    from fa2_jax.ops.quant import quantize_tensor

    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    k = jax.random.normal(ks[0], (B, Hkv, S, D)) * 0.5
    v = jax.random.normal(ks[1], (B, Hkv, S, D)) * 0.5
    if qdtype is None:
        return k, v, None, None, k, v
    kq, ksc = quantize_tensor(k, qdtype)
    vq, vsc = quantize_tensor(v, qdtype)
    kd, vd = kq.astype(jnp.float32) * ksc, vq.astype(jnp.float32) * vsc
    return (kq, vq, jnp.swapaxes(ksc, 2, 3), jnp.swapaxes(vsc, 2, 3), kd, vd)


def _paged(x, page):
    B, H, S = x.shape[:3]
    n = S // page
    return x.reshape(B, H, n, page, *x.shape[3:]).swapaxes(1, 2).reshape(
        B * n, H, page, *x.shape[3:])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("qdtype", [None, jnp.int8, jnp.float8_e4m3fn])
def test_decode_caches(paged, qdtype):
    from fa2_jax.ops.decode import decode_attention, paged_decode_attention

    k, v, ksc, vsc, kd, vd = _cache(qdtype)
    q = jax.random.normal(jax.random.PRNGKey(9), (3, 8, 32)) * 0.5
    lens = jnp.asarray([1, 70, 128], jnp.int32)
    if paged:
        # Each sequence's pages sit in the pool in reverse order, so the
        # block table (logical page i of b -> pool page 8b + 7 - i) matters.
        tables = jnp.arange(3 * 8, dtype=jnp.int32).reshape(3, 8)[:, ::-1]

        def pool(x):
            p = _paged(x, 16)
            return p.reshape(3, 8, *p.shape[1:])[:, ::-1].reshape(p.shape)

        out = paged_decode_attention(
            q, pool(k), pool(v), tables, lens,
            None if ksc is None else pool(jnp.swapaxes(ksc, 2, 3)).swapaxes(2, 3),
            None if vsc is None else pool(jnp.swapaxes(vsc, 2, 3)).swapaxes(2, 3))
    else:
        out = decode_attention(q, k, v, lens, ksc, vsc, block_kv=32)
    assert _err(out, _decode_oracle(q, kd, vd, lens)) < 1e-4


@pytest.mark.parametrize("block_kv", [16, 64, 256])
def test_decode_window_softcap_and_split_edges(block_kv):
    """8 (batch, KV head) programs split a 256-long cache into 16, 4 or 1
    KV splits (one per block); lengths sit on, just past and far from the
    split edges, and the window starts mid-split."""
    from fa2_jax.ops.decode import decode_attention

    k, v, _, _, kd, vd = _cache(None, B=4, S=256)
    q = jax.random.normal(jax.random.PRNGKey(3), (4, 8, 32)) * 0.5
    lens = jnp.asarray([1, 64, 65, 256], jnp.int32)
    out = decode_attention(q, k, v, lens, block_kv=block_kv, window_left=40,
                           softcap=8.0)
    ref = _decode_oracle(q, kd, vd, lens, window_left=40, softcap=8.0)
    assert _err(out, ref) < 1e-4


def test_decode_quantized_cache_needs_scales():
    from fa2_jax.ops.decode import decode_attention

    k, v, _, _, _, _ = _cache(jnp.float8_e4m3fn)
    q = jnp.zeros((3, 8, 32))
    with pytest.raises(AssertionError, match="needs its k_scale"):
        decode_attention(q, k, v, jnp.asarray([1, 2, 3], jnp.int32))


@pytest.mark.parametrize("platform,interpret", [
    ("cpu", True), ("gpu", False), (None, True),
])
def test_kernel_route(platform, interpret):
    from fa2_jax.utils import use_interpreter

    assert use_interpreter(platform) is interpret


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_kernel_route_unknown_platform_raises(platform):
    from fa2_jax.utils import use_interpreter

    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        use_interpreter(platform)


def _lower_for_cuda(f, *args):
    import fa2_jax.utils.common as common

    with mock.patch.object(common, "use_interpreter",
                           lambda platform=None: False):
        return jax.jit(f).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()


def _fwd_bwd(q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(flash_attn_func(
        q, k, v, causal=True, dropout_p=0.1, dropout_seed=1,
        window_size=(32, 0), softcap=10.0).astype(jnp.float32)),
        argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("which", ["fwd_bwd", "decode", "paged", "varlen"])
def test_kernels_lower_through_triton_for_cuda(which):
    """Every kernel lowers on the Triton route for CUDA (no GPU needed):
    catches primitives or shapes the route cannot express."""
    from fa2_jax import flash_attn_varlen_func
    from fa2_jax.ops.decode import decode_attention, paged_decode_attention

    bf = jnp.bfloat16
    if which == "fwd_bwd":
        q = jnp.zeros((1, 128, 4, 64), bf)
        k = jnp.zeros((1, 128, 2, 64), bf)
        txt = _lower_for_cuda(_fwd_bwd, q, k, k)
        n = 3
    elif which == "decode":
        kc = jnp.zeros((2, 2, 128, 64), jnp.int8)
        sc = jnp.ones((2, 2, 1, 128))
        txt = _lower_for_cuda(
            lambda q, k: decode_attention(q, k, k, jnp.asarray([5, 9]), sc, sc),
            jnp.zeros((2, 8, 64), bf), kc)
        n = 1
    elif which == "paged":
        kp = jnp.zeros((8, 2, 16, 64), jnp.float8_e4m3fn)
        sc = jnp.ones((8, 2, 1, 16))
        tab = jnp.zeros((2, 4), jnp.int32)
        txt = _lower_for_cuda(
            lambda q, k: paged_decode_attention(q, k, k, tab,
                                                jnp.asarray([5, 9]), sc, sc),
            jnp.zeros((2, 8, 64), bf), kp)
        n = 1
    else:
        q = jnp.zeros((256, 4, 64), bf)
        k = jnp.zeros((256, 2, 64), bf)
        txt = _lower_for_cuda(jax.grad(lambda q, k, v: jnp.sum(
            flash_attn_varlen_func(q, k, v, [0, 128, 256], seqlens=(100, 128),
                                   causal=True).astype(jnp.float32)),
            argnums=(0, 1, 2)), q, k, k)
        n = 3
    assert txt.count("__gpu$xla.gpu.triton") == n


def test_unknown_device_kind_has_no_peak():
    from fa2_jax.utils.profiling import chip_spec, roofline

    assert chip_spec("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        chip_spec("Some Accelerator X1")
    with pytest.raises(KeyError):
        roofline(1.0, 1.0, 1.0, chip="cpu")


def test_compile_cache_dir(monkeypatch):
    from fa2_jax.utils import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    with mock.patch.object(jax.config, "update") as update:
        assert enable_compile_cache() == "/some/where"
        update.assert_not_called()   # JAX reads the variable itself
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    with mock.patch.object(jax.config, "update") as update:
        path = enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        update.assert_called_once_with("jax_compilation_cache_dir", path)


def test_numpy_checkpoint_roundtrip_dtypes_and_sharding(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fa2_jax.parallel import make_mesh
    from fa2_jax.utils.checkpoint import CheckpointManager

    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    sh = NamedSharding(mesh, P("data", None))
    state = {
        "w": jax.device_put(jnp.arange(8.0).reshape(4, 2).astype(jnp.bfloat16), sh),
        "q": jnp.asarray([[1, -2]], jnp.int8),
        "f8": jnp.asarray([0.5, -1.25], jnp.float8_e4m3fn),
        "n": {"step": jnp.int32(7), "s": jnp.float32(2.5)},
    }
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, jax.tree.map(lambda x: x + 0 * step, state),
                 wait=step != 3)
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    out = mgr.restore(state)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              np.asarray(b.astype(jnp.float32)))
    assert out["w"].sharding == sh
    mgr.close()


def test_numpy_checkpoint_empty_dir(tmp_path):
    from fa2_jax.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.latest_step() is None
    with pytest.raises(AssertionError, match="no checkpoint"):
        mgr.restore({"a": jnp.zeros(2)})
