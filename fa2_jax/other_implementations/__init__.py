"""Third-party attention baselines for benchmarking.

Counterpart of the reference's `src/other_implementations/`
(`/root/reference/src/other_implementations/flex_attention.py`): the
reference compares its Triton kernel against `torch.nn.attention
.flex_attention`; here the comparison points are

* `xla_attention`   — dense unfused attention lowered by XLA (the
  "PyTorch eager oracle" analog, and what most JAX users write by hand),
* `cudnn_attention` — cuDNN's fused attention through
  `jax.nn.dot_product_attention(implementation="cudnn")`.

Both take the same BSHD layout as `fa2_jax.flash_attn_func` so the
benchmark harness can swap kernels without re-laying-out data (the reference
does a layout transpose when switching to Flex, `benchmarks/utils.py:65-69`).
"""
from fa2_jax.other_implementations.baselines import (
    cudnn_attention,
    xla_attention,
)

__all__ = ["xla_attention", "cudnn_attention"]
