"""Forward-only grid including dropout (reference `tests/test_fwd_only.py`).

Dropout is checked by handing the oracle the *same* counter-based keep-mask
the kernel generates internally (see `fa2_jax/utils/rng.py` — the
replacement for the reference's Triton `tl.rand` stream
replication, `tests/utils.py:169-207` there).
"""
import jax.numpy as jnp
import pytest

from tests.core import run_attention_case


@pytest.mark.parametrize("dropout_p,causal", [(0.1, False), (0.1, True), (0.5, False)])
def test_dropout_fwd(dropout_p, causal):
    run_attention_case(
        2, 4, 2, 255, 255, 64, causal=causal, dropout_p=dropout_p,
        forward_only=True,
    )


@pytest.mark.parametrize("dropout_p", [0.1])
def test_dropout_with_mask(dropout_p):
    run_attention_case(
        2, 4, 2, 128, 128, 64, causal=False, dropout_p=dropout_p,
        use_attention_mask=True, forward_only=True,
    )


def test_dropout_bwd():
    """Backward + dropout works here (reference raises, `src/utils.py:88`)."""
    run_attention_case(2, 4, 2, 128, 128, 64, causal=True, dropout_p=0.1)


def test_dropout_rate():
    """The realized dropout fraction is close to dropout_p."""
    from fa2_jax.utils.rng import dropout_keep_mask_reference

    mask = dropout_keep_mask_reference(7, 0.3, 2, 4, 128, 128)
    frac = 1.0 - float(jnp.mean(mask.astype(jnp.float32)))
    assert abs(frac - 0.3) < 0.01, frac
