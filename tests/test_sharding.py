"""Multi-device tests on the 8-virtual-CPU-device mesh: sharded results must
match single-device kernel results on the same data (SURVEY.md §4's
"sharded == single-device-gather numerics" rule)."""
import jax
import jax.numpy as jnp
import pytest

from fa2_jax import flash_attn_func
from fa2_jax.parallel import (
    make_mesh, make_ring_attention, make_tp_attention,
)
from tests.utils import generate_test_data

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4,
    reason="needs >= 4 devices (run on the virtual CPU mesh, tests/conftest.py)",
)


def _err(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


@pytest.mark.parametrize("causal", [False, True])
def test_tp_dp_attention_matches_single_device(causal):
    mesh = make_mesh(data=2, model=2, seq=1)
    q, k, v, _ = generate_test_data(4, 8, 4, 128, 128, 64, jnp.float32)
    fn = make_tp_attention(mesh, causal=causal)
    out = fn(q, k, v)
    ref = flash_attn_func(q, k, v, causal=causal)
    assert _err(out, ref) < 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_single_device(causal):
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, _ = generate_test_data(2, 4, 4, 512, 512, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=causal)
    out = jax.jit(fn)(q, k, v)
    ref = flash_attn_func(q, k, v, causal=causal)
    assert _err(out, ref) < 2e-5


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_backward_matches_single_device(causal):
    """Ring bwd: dq local, (k, v, dk, dv) travel the ring — must equal the
    single-device custom_vjp gradients."""
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, do = generate_test_data(2, 4, 2, 512, 512, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=causal)

    out, vjp = jax.vjp(fn, q, k, v)
    dq, dk, dv = vjp(do)
    out_ref, vjp_ref = jax.vjp(
        lambda q, k, v: flash_attn_func(q, k, v, causal=causal), q, k, v
    )
    dq_ref, dk_ref, dv_ref = vjp_ref(do)
    assert _err(out, out_ref) < 2e-5
    assert _err(dq, dq_ref) < 2e-5, _err(dq, dq_ref)
    assert _err(dk, dk_ref) < 2e-5, _err(dk, dk_ref)
    assert _err(dv, dv_ref) < 2e-5, _err(dv, dv_ref)


def test_ring_attention_gqa_with_tp():
    mesh = make_mesh(data=1, model=2, seq=4)
    q, k, v, _ = generate_test_data(2, 8, 4, 512, 512, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True)
    out = jax.jit(fn)(q, k, v)
    ref = flash_attn_func(q, k, v, causal=True)
    assert _err(out, ref) < 2e-5


def test_multihost_mesh_layout():
    """make_multihost_mesh puts data outermost (DCN) and model/seq within a
    host's chips (ICI); on one (virtual) host it must still work and keep
    model-axis neighbors adjacent in device order."""
    from fa2_jax.parallel.mesh import make_multihost_mesh

    mesh = make_multihost_mesh(model=2, seq=2)
    assert mesh.shape["model"] == 2 and mesh.shape["seq"] == 2
    assert mesh.shape["data"] == len(jax.devices()) // 4
    # model/seq vary fastest -> same-data-group devices are contiguous.
    flat = mesh.devices.reshape(mesh.shape["data"], -1)
    ids = [d.id for d in flat[0]]
    assert ids == sorted(ids)


def test_ring_zigzag_causal_fwd_bwd():
    """S=1024 over 4 devices -> 128-row zigzag chunks: the balanced causal
    schedule actually engages (each device holds chunks (i, 2n-1-i))."""
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, do = generate_test_data(1, 4, 2, 1024, 1024, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True)  # zigzag auto-on
    out, vjp = jax.vjp(fn, q, k, v)
    out_ref, vjp_ref = jax.vjp(
        lambda q, k, v: flash_attn_func(q, k, v, causal=True), q, k, v)
    assert _err(out, out_ref) < 2e-5
    for g, g_ref, name in zip(vjp(do), vjp_ref(do), ("dq", "dk", "dv")):
        assert _err(g, g_ref) < 3e-5, (name, _err(g, g_ref))


def test_ring_dropout_matches_single_device():
    """The ring's dropout counter stream is global-position based, so it is
    bitwise the single-chip kernel's stream — with the SAME (nonzero) seed
    plumbed through `make_ring_attention(dropout_seed=...)`. S=2048 over 4
    devices gives 256-row zigzag chunks, which routes diagonal pairs through
    the static-triangular kernels — pinning that THEY use global offsets in
    the dropout counter too (regression: they once used local positions)."""
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, do = generate_test_data(1, 4, 2, 2048, 2048, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True, dropout_p=0.2,
                             dropout_seed=1234)
    out, vjp = jax.vjp(fn, q, k, v)
    ref, vjp_ref = jax.vjp(
        lambda q, k, v: flash_attn_func(q, k, v, causal=True, dropout_p=0.2,
                                        dropout_seed=1234), q, k, v)
    assert _err(out, ref) < 2e-5
    for g, g_ref, name in zip(vjp(do), vjp_ref(do), ("dq", "dk", "dv")):
        assert _err(g, g_ref) < 5e-5, (name, _err(g, g_ref))


def test_ring_dropout_rng_key_and_seed_required():
    """Ring dropout shares flash_attn_func's seed contract: dropout_p > 0
    with neither dropout_seed nor dropout_rng raises; a per-call rng key is
    accepted and changes the mask vs a different key."""
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, _ = generate_test_data(1, 4, 2, 1024, 1024, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True, dropout_p=0.2)
    with pytest.raises(ValueError, match="dropout_seed or dropout_rng"):
        fn(q, k, v)
    out_a = fn(q, k, v, dropout_rng=jax.random.key(0))
    out_b = fn(q, k, v, dropout_rng=jax.random.key(1))
    assert _err(out_a, out_b) > 1e-3  # different keys -> different masks


def test_ring_window_matches_single_device():
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, _ = generate_test_data(1, 4, 2, 1024, 1024, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True, window=(300, 0))
    out = jax.jit(fn)(q, k, v)
    ref = flash_attn_func(q, k, v, causal=True, window_size=(300, 0))
    assert _err(out, ref) < 2e-5


def test_ring_lse_differentiable():
    """return_lse=True through the ring is differentiable (the LSE cotangent
    folds into every chunk's delta)."""
    mesh = make_mesh(data=1, model=1, seq=4)
    q, k, v, _ = generate_test_data(1, 4, 2, 1024, 1024, 64, jnp.float32)
    fn = make_ring_attention(mesh, causal=True, return_lse=True)

    def loss_ring(q):
        o, lse = fn(q, k, v)
        return jnp.sum(o * o) + jnp.sum(jnp.sin(lse))

    def loss_ref(q):
        o, lse = flash_attn_func(q, k, v, causal=True, return_lse=True)
        return jnp.sum(o * o) + jnp.sum(jnp.sin(lse))

    assert _err(jax.grad(loss_ring)(q), jax.grad(loss_ref)(q)) < 5e-5
