"""Auxiliary subsystems: weight-only quantization, checkpoint/resume,
roofline reporting, kernel export tool."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fa2_jax.models import LlamaConfig, forward, init_params
from fa2_jax.models.llama import quantize_model_params
from fa2_jax.ops.quant import qmatmul, quantize_weight

CFG = LlamaConfig(
    vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    hidden_dim=128, max_seq_len=128, dtype=jnp.float32,
)


def test_weight_only_quantized_matmul():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.normal(0, 1, (16, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(0, 0.1, (64, 32)), jnp.float32)
    qw = quantize_weight(w, jnp.int8)
    err = float(jnp.max(jnp.abs(qmatmul(x, qw) - x @ w)))
    ref_mag = float(jnp.max(jnp.abs(x @ w)))
    assert err < 0.05 * ref_mag, (err, ref_mag)


def test_quantized_model_forward_close():
    params = init_params(jax.random.PRNGKey(0), CFG)
    qparams = quantize_model_params(params, jnp.int8)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, CFG.vocab_size)
    logits = forward(params, tokens, CFG)
    qlogits = forward(qparams, tokens, CFG)
    # int8 weights shift logits slightly but ranks should broadly agree.
    top1 = jnp.argmax(logits, -1)
    qtop1 = jnp.argmax(qlogits, -1)
    agreement = float(jnp.mean((top1 == qtop1).astype(jnp.float32)))
    assert agreement > 0.8, agreement


def test_checkpoint_save_restore_roundtrip():
    from fa2_jax.utils.checkpoint import CheckpointManager

    params = init_params(jax.random.PRNGKey(0), CFG)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, max_to_keep=2)
        mgr.save(1, params)
        mgr.save(2, jax.tree.map(lambda x: x + 1.0 if x.dtype != jnp.int8 else x, params))
        assert mgr.latest_step() == 2
        restored = mgr.restore(params)
        leaf = restored["layers"][0]["wq"]
        orig = params["layers"][0]["wq"]
        assert float(jnp.max(jnp.abs(leaf - (orig + 1.0)))) == 0.0
        restored1 = mgr.restore(params, step=1)
        assert float(jnp.max(jnp.abs(restored1["layers"][0]["wq"] - orig))) == 0.0
        mgr.close()


def test_roofline_report():
    from fa2_jax.utils.profiling import roofline

    r = roofline(time_s=1e-3, flops=100e9, bytes_moved=100e6,
                 chip="NVIDIA H100 80GB HBM3")
    assert r.compute_bound
    assert 0 < r.utilization < 1
    assert "TFLOP/s" in r.summary()


def test_export_kernels_tool():
    import subprocess, sys
    with tempfile.TemporaryDirectory() as d:
        target = os.path.join(d, "vendored_fa2")
        subprocess.run(
            [sys.executable, "tools/export_kernels.py", target],
            check=True, capture_output=True,
        )
        assert os.path.exists(os.path.join(target, "ops", "flash_fwd.py"))
        code = open(os.path.join(target, "ops", "flash_fwd.py")).read()
        assert "from vendored_fa2.utils" in code
        assert "from fa2_jax" not in code
        # The vendored package must import standalone (on the CPU: this
        # check is about imports, not devices).
        import subprocess as sp, sys as s2
        r = sp.run([s2.executable, "-c",
                    "import sys; sys.path.insert(0, %r); "
                    "import jax; jax.config.update('jax_platforms', 'cpu'); "
                    "import vendored_fa2; print('ok')" % d],
                   capture_output=True, text=True)
        assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-500:]


def test_resilient_trainer_skips_nonfinite_and_resumes():
    import jax as _jax
    import jax.numpy as _jnp
    from fa2_jax.utils.resilience import (
        ResilientTrainer, devices_healthy, make_guarded_step, tree_allfinite,
    )

    assert devices_healthy(_jax.devices())
    assert devices_healthy()
    assert bool(tree_allfinite({"a": _jnp.ones(3), "n": _jnp.arange(3)}))
    assert not bool(tree_allfinite({"a": _jnp.array([1.0, _jnp.nan])}))

    # step: params -= 0.1 * batch; a batch of NaN must be skipped wholesale.
    def step(state, batch):
        new = _jax.tree.map(lambda p: p - 0.1 * batch, state)
        return new, _jnp.sum(batch)

    guarded = _jax.jit(make_guarded_step(step))
    state = {"w": _jnp.ones((4,))}
    state, loss, ok = guarded(state, _jnp.float32(1.0))
    assert bool(ok) and float(state["w"][0]) == pytest.approx(0.9)
    state, loss, ok = guarded(state, _jnp.float32(float("nan")))
    assert not bool(ok)
    assert float(state["w"][0]) == pytest.approx(0.9)  # rolled back

    with tempfile.TemporaryDirectory() as d:
        tr = ResilientTrainer(step, d, save_every=2)
        s0 = {"w": jnp.ones((4,))}
        s, start = tr.restore_or_init(s0)
        assert start == 0
        s = tr.run(s, [jnp.float32(1.0)] * 4, start_step=start)
        assert tr.report.steps_run == 4
        tr.close()
        # Simulated crash: a fresh trainer resumes from the saved step.
        tr2 = ResilientTrainer(step, d, save_every=2)
        s2, start2 = tr2.restore_or_init(s0)
        assert start2 == 4 and tr2.report.resumed_from == 4
        assert float(jnp.max(jnp.abs(s2["w"] - s["w"]))) == 0.0
        tr2.close()
