"""Pinned adversarial configurations (reference `tests/test_race_conditions.py`
analog, drawn from the reference's documented bug graveyard at
`investigate_result.py:122-164`): shapes that historically broke
flash-attention implementations — pipelining bugs at head_dim=64 with
s=(113,255) + matrix bias, races at head dims 48/96, one-coefficient dV
errors. The Pallas kernels have no cross-program races by construction, but these
shapes stress the same edge paths (masked edge blocks, non-pow2 head dims,
asymmetric causal diagonals), so they stay pinned here.
"""
import pytest

from tests.core import run_attention_case

PINNED = [
    # (B, Hq, Hkv, Sq, Sk, D, causal, mask, bias)
    (4, 4, 4, 113, 255, 64, False, False, True),   # pipelining bug config
    (4, 4, 4, 113, 255, 64, True, False, True),
    (2, 4, 2, 255, 255, 48, True, False, False),   # race at head_dim 48
    (2, 4, 2, 255, 255, 96, True, False, False),   # race at head_dim 96
    (2, 8, 1, 255, 113, 64, True, False, False),   # seqlen_q > seqlen_k causal (dead rows)
    (1, 2, 1, 239, 1, 32, True, False, False),     # single-key edge
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,mask,bias", PINNED)
def test_pinned_config(B, Hq, Hkv, Sq, Sk, D, causal, mask, bias):
    run_attention_case(
        B, Hq, Hkv, Sq, Sk, D, causal=causal,
        use_attention_mask=mask, use_bias=bias,
    )
