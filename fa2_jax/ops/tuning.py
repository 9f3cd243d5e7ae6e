"""Block sizes and launch parameters for the Triton-route attention kernels.

Plays the role of the reference's `triton.autotune` config lists
(`src/forward/kernel.py:35-59`, `src/backward/kernel.py:34-63`) as one static
rule: what Triton needs (block rows/columns, `num_warps`, `num_stages`),
chosen from the head dim and the element width. Blocks are powers of two and
at least 16 (`tl.dot` operand shapes); sequences are padded to a multiple of
the largest block of their axis (`ops/attention.py`).
"""
from __future__ import annotations

from dataclasses import dataclass

from fa2_jax.utils import next_power_of_2

MIN_BLOCK = 16


@dataclass(frozen=True)
class BlockSizes:
    # Forward: one program per block_q rows, looping over block_kv columns.
    block_q: int
    block_kv: int
    # Backward: the dq kernel owns block_q_bwd rows and loops over
    # block_kv_bwd columns; the dk/dv kernel owns block_kv_bwd columns and
    # loops over block_q_bwd rows.
    block_q_bwd: int
    block_kv_bwd: int
    num_warps: int = 4
    num_stages: int = 2
    num_warps_bwd: int = 4
    num_stages_bwd: int = 2

    def __post_init__(self):
        for v in (self.block_q, self.block_kv, self.block_q_bwd,
                  self.block_kv_bwd):
            assert v >= MIN_BLOCK and v & (v - 1) == 0, (
                "blocks must be powers of two, at least 16")

    @property
    def q_multiple(self) -> int:
        """Multiple the padded query length must have."""
        return max(self.block_q, self.block_q_bwd)

    @property
    def kv_multiple(self) -> int:
        return max(self.block_kv, self.block_kv_bwd)


def fit_block(block: int, seqlen: int) -> int:
    """`block`, shrunk to the next power of two of a shorter sequence (never
    below 16) so short inputs are not padded past themselves."""
    return max(MIN_BLOCK, min(block, next_power_of_2(max(seqlen, 1))))


def choose_block_sizes(seqlen_q: int, seqlen_k: int, head_dim_padded: int,
                       dtype_bits: int = 16, **_unused) -> BlockSizes:
    """Launch shape from head dim and element width.

    Register and shared-memory pressure grow with block area times head dim
    and with the element width, so wide heads and fp32 inputs get narrower
    column blocks. Remaining keyword arguments (causal, bias, ...) are
    accepted for callers that describe the problem more fully; the rule
    does not depend on them.
    """
    wide = dtype_bits > 16
    if head_dim_padded <= 64:
        bq, bkv, warps, stages = 128, 64, 4, 3
    elif head_dim_padded <= 128:
        bq, bkv, warps, stages = 128, 64 if not wide else 32, 8, 3
    else:
        bq, bkv, warps, stages = 64, 32, 8, 2
    bq_b, bkv_b = (64, 64) if head_dim_padded <= 128 and not wide else (32, 32)
    return BlockSizes(
        block_q=fit_block(bq, seqlen_q),
        block_kv=fit_block(bkv, seqlen_k),
        block_q_bwd=fit_block(bq_b, seqlen_q),
        block_kv_bwd=fit_block(bkv_b, seqlen_k),
        num_warps=warps,
        num_stages=stages,
        num_warps_bwd=4 if head_dim_padded <= 64 else 8,
        num_stages_bwd=2,
    )
