"""Perplexity evaluation over a token corpus.

Completes the training loop's other half: load a checkpoint saved by
`examples/train.py` (or evaluate a fresh init), stream deterministic
windows from the memmapped corpus (`utils/data.py`), and report token-level
cross-entropy / perplexity. The eval step is one jitted forward per batch
(no grads, so remat is irrelevant and activation memory is a single layer).

  python examples/eval.py --data corpus.bin --ckpt-dir .ckpt/train \
      --batches 50 --batch 8 --seq 2048 --dim 1024 --layers 8
"""
from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--data", required=True, metavar="FILE")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train.py checkpoint to evaluate (fresh init if "
                         "omitted — useful as a sanity upper bound)")
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from fa2_jax.models import LlamaConfig, init_params, loss_fn
    from fa2_jax.utils.data import TokenLoader, open_corpus

    cfg = LlamaConfig(
        vocab_size=args.vocab, dim=args.dim, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads,
        hidden_dim=int(args.dim * 2.75) // 128 * 128,
        max_seq_len=args.seq + 1,
        dtype=jnp.dtype(args.dtype),
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    if args.ckpt_dir:
        import optax

        from fa2_jax.utils.checkpoint import CheckpointManager

        # Reconstruct train.py's DEFAULT-flags state structure (the
        # checkpoint restores into a like-shaped pytree); custom --lr/--warmup/--clip
        # runs keep the same tree shape, so any train.py checkpoint loads.
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(optax.constant_schedule(3e-4),
                                      weight_decay=0.01))
        mgr = CheckpointManager(args.ckpt_dir)
        state = mgr.restore({"params": params, "opt": opt.init(params),
                             "step": jnp.int32(0)})
        params, step = state["params"], state["step"]
        mgr.close()
        print(f"evaluating checkpoint step {int(step)}")

    eval_step = jax.jit(lambda p, t: loss_fn(p, t, cfg))
    loader = TokenLoader(open_corpus(args.data, args.vocab), args.batch,
                         args.seq, seed=args.seed)
    total, n = 0.0, 0
    for i, batch in enumerate(loader):
        if i >= args.batches:
            break
        total += float(eval_step(params, jnp.asarray(batch)))
        n += 1
    nll = total / max(n, 1)
    print(f"{n} batches ({n * args.batch * args.seq} tokens): "
          f"cross-entropy {nll:.4f} nats/token, "
          f"perplexity {math.exp(nll):.2f}")


if __name__ == "__main__":
    main()
