"""Debug visualizer — parity with the reference's `investigate_result.py`:
re-runs one attention configuration, renders heatmaps of |ours - oracle| for
the output and all three gradients to `__tmp__.png`, and prints max/mean
diffs. Use when a tolerance test fails to SEE the error structure (block
edges, diagonal bands, single coefficients).

Usage:
    python tools/investigate_result.py --seqlen-q 113 --seqlen-k 255 --causal
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fa2_jax import flash_attn_func, flash_attn_reference  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--heads-q", type=int, default=4)
    ap.add_argument("--heads-kv", type=int, default=2)
    ap.add_argument("--seqlen-q", type=int, default=113)
    ap.add_argument("--seqlen-k", type=int, default=255)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default="__tmp__.png")
    args = ap.parse_args()

    dtype = getattr(jnp, args.dtype)
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.normal(0, 0.5, (args.batch, args.seqlen_q, args.heads_q, args.head_dim)), dtype)
    k = jnp.asarray(rng.normal(0, 0.5, (args.batch, args.seqlen_k, args.heads_kv, args.head_dim)), dtype)
    v = jnp.asarray(rng.normal(0, 0.5, (args.batch, args.seqlen_k, args.heads_kv, args.head_dim)), dtype)
    do = jnp.asarray(rng.normal(0, 0.5, q.shape), dtype)

    out_ref, vjp_ref = jax.vjp(lambda *a: flash_attn_reference(*a, causal=args.causal), q, k, v)
    out, vjp = jax.vjp(lambda *a: flash_attn_func(*a, causal=args.causal), q, k, v)
    grads = vjp(do)
    grads_ref = vjp_ref(do)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = ["out", "dq", "dk", "dv"]
    tensors = [(out, out_ref)] + list(zip(grads, grads_ref))
    fig, axes = plt.subplots(1, 4, figsize=(22, 5))
    for ax, name, (a, b) in zip(axes, names, tensors):
        diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        img = diff[0].mean(axis=1) if diff.ndim == 4 else diff[0]
        im = ax.imshow(img, aspect="auto", cmap="magma")
        ax.set_title(f"{name}: max={diff.max():.2e} mean={diff.mean():.2e}")
        fig.colorbar(im, ax=ax)
        print(f"{name}: max diff {diff.max():.3e}, mean diff {diff.mean():.3e}")
    fig.suptitle(f"|ours - oracle|  Sq={args.seqlen_q} Sk={args.seqlen_k} "
                 f"causal={args.causal} dtype={args.dtype}")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
