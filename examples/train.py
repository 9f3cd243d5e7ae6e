"""End-to-end distributed training example.

Everything in one script: a LLaMA-style model on the Pallas flash-attention
kernels, a (data x model) device mesh with TP-sharded parameters, an
optax/adamw train step jitted under sharding constraints, failure-tolerant
stepping (non-finite steps roll back), periodic checkpoints with
restore-on-restart, and a roofline report per step on the GPU.

Run on the GPU(s) as-is, or simulate a mesh on CPU (kernels interpreted):

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/train.py --platform cpu --dp 4 --tp 2 --steps 8 \
      --dtype float32
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_optimizer(lr: float = 3e-4, warmup: int = 0, steps: int = 1,
                   grad_clip: float = 1.0):
    """adamw behind global-norm clipping. Always a SCHEDULE (constant when
    no warmup) and always the clip link (inf norm = off): the optimizer
    state tree shape stays invariant across flag choices, so any train.py
    checkpoint restores into any other run's (or examples/eval.py's)
    reconstruction."""
    import optax

    sched = (optax.warmup_cosine_decay_schedule(
                 0.0, lr, warmup, max(steps, warmup + 1), end_value=lr / 10)
             if warmup else optax.constant_schedule(lr))
    return optax.chain(
        optax.clip_by_global_norm(grad_clip if grad_clip > 0 else float("inf")),
        optax.adamw(sched, weight_decay=0.01),
    )


def make_step_fn(cfg, opt, loss_fn):
    """step_fn(state, tokens) -> (new_state, loss) for `ResilientTrainer`;
    state = {"params", "opt", "step"}."""
    import jax
    import optax

    def step_fn(state, tokens):
        lval, grads = jax.value_and_grad(
            lambda p: loss_fn(p, tokens, cfg))(state["params"])
        updates, opt_state = opt.update(grads, state["opt"], state["params"])
        new_params = optax.apply_updates(state["params"], updates)
        return {"params": new_params, "opt": opt_state,
                "step": state["step"] + 1}, lval

    return step_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="parameter/activation dtype")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.path.dirname(__file__), "..", ".ckpt", "train"))
    ap.add_argument("--save-every", type=int, default=5)
    ap.add_argument("--moe", type=int, default=0, metavar="E",
                    help="train a MoE model with E experts (top-2 routing)")
    ap.add_argument("--remat", action="store_true",
                    help="per-layer gradient checkpointing")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard params/grads/optimizer over data")
    ap.add_argument("--data", default=None, metavar="FILE",
                    help="flat binary token corpus (utils/data.py); "
                         "synthetic random tokens when omitted")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=0, metavar="STEPS",
                    help="linear warmup then cosine decay to lr/10 over "
                         "--steps (0 = constant lr)")
    ap.add_argument("--grad-clip", type=float, default=1.0, metavar="NORM",
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--steps-per-call", type=int, default=8, metavar="K",
                    help="optimizer steps per host dispatch (lax.scan over "
                         "K stacked batches); amortizes the per-dispatch "
                         "host cost")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fa2_jax.models import LlamaConfig, init_params, loss_fn
    if args.moe:
        from fa2_jax.models.moe import (
            MoEConfig as LlamaConfig, init_params, loss_fn,
        )
    from fa2_jax.parallel import (
        AXIS_DATA, fsdp_param_pspecs, make_mesh, shard_params,
    )
    from fa2_jax.utils import enable_compile_cache
    from fa2_jax.utils.profiling import roofline
    from fa2_jax.utils.resilience import ResilientTrainer, devices_healthy

    enable_compile_cache()
    assert devices_healthy(), "device probe failed"
    mesh = make_mesh(data=args.dp, model=args.tp)
    extra = dict(n_experts=args.moe) if args.moe else {}
    cfg = LlamaConfig(
        vocab_size=32000, dim=args.dim, n_layers=args.layers,
        n_heads=8, n_kv_heads=2, hidden_dim=int(args.dim * 2.75) // 128 * 128,
        max_seq_len=args.seq, dtype=jnp.dtype(args.dtype),
        remat=args.remat, **extra,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    specs = fsdp_param_pspecs(params, mesh) if args.fsdp else None
    params = shard_params(params, mesh, specs=specs)
    opt = make_optimizer(args.lr, args.warmup, args.steps, args.grad_clip)
    state = {"params": params, "opt": opt.init(params), "step": jnp.int32(0)}

    # Give every leaf an explicit mesh sharding (scalars like the adam step
    # counter replicate): uniform shardings keep jit happy and survive the
    # checkpoint restore round-trip.
    def with_mesh_sharding(x):
        x = jnp.asarray(x)
        if isinstance(getattr(x, "sharding", None), NamedSharding):
            return x
        return jax.device_put(x, NamedSharding(mesh, P()))

    state = jax.tree.map(with_mesh_sharding, state)

    batch_sharding = NamedSharding(mesh, P(AXIS_DATA, None))

    step_fn = make_step_fn(cfg, opt, loss_fn)

    spc = max(1, min(args.steps_per_call, args.steps))
    trainer = ResilientTrainer(step_fn, args.ckpt_dir,
                               save_every=args.save_every,
                               steps_per_call=spc)
    state, start = trainer.restore_or_init(state)
    if start:
        print(f"resumed from checkpoint step {start}")

    rng = np.random.RandomState(start)
    tokens_per_step = args.batch * (args.seq - 1)
    # ~6 * params * tokens FLOPs for a decoder fwd+bwd.
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    flops_per_step = 6 * n_params * tokens_per_step

    # K-step stacks for the full groups, single steps for the remainder: a
    # ragged final stack would be a new scan length (a recompile inside the
    # timed region).
    n_stacked = args.steps // spc * spc if spc > 1 else 0

    def raw_batches():
        if args.data:
            from itertools import islice

            from fa2_jax.utils.data import TokenLoader, open_corpus

            dl = TokenLoader(open_corpus(args.data, cfg.vocab_size),
                             args.batch, args.seq - 1, seed=0)
            yield from islice(iter(dl), args.steps)
        else:
            # Synthetic tokens ride the same pipeline as real data.
            for _ in range(args.steps):
                yield np.asarray(
                    rng.randint(0, cfg.vocab_size,
                                size=(args.batch, args.seq)), np.int32)

    def stacks(raw):
        # Host-stack K batches and ship each stack as ONE transfer.
        group = []
        for b in raw:
            group.append(np.asarray(b))
            if len(group) == spc:
                yield np.stack(group)
                group = []

    from itertools import islice

    from fa2_jax.utils.data import prefetch_to_device

    raw = raw_batches()
    stacked_batches = prefetch_to_device(
        stacks(islice(raw, n_stacked)), size=2,
        sharding=NamedSharding(mesh, P(None, AXIS_DATA, None)))
    single_batches = prefetch_to_device(raw, size=2, sharding=batch_sharding)

    # Compile (and warm) every program the timed region runs, on a throwaway
    # batch whose result is discarded, so no optimizer step is applied
    # outside the counted ones.
    warm = np.zeros((args.batch, args.seq), np.int32)
    if n_stacked:
        jax.block_until_ready(trainer._multi(
            state, jax.device_put(np.stack([warm] * spc),
                                  NamedSharding(mesh, P(None, AXIS_DATA, None)))))
    if args.steps > n_stacked:
        jax.block_until_ready(trainer._step(
            state, jax.device_put(warm, batch_sharding)))

    t0 = time.perf_counter()
    if n_stacked:
        state = trainer.run(state, stacked_batches, start_step=start,
                            final_save=False, stacked=True)
    state = trainer.run(state, single_batches, start_step=start + n_stacked,
                        final_save=False)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    trainer._ckpt.save(start + args.steps, state)
    msg = (f"{args.steps} steps in {dt:.2f}s — loss "
           f"{trainer.report.last_loss:.4f}, skipped "
           f"{trainer.report.steps_skipped}")
    if jax.devices()[0].platform == "gpu":
        # Device peaks exist for GPUs only (a CPU run has no roofline).
        r = roofline(time_s=dt / max(args.steps, 1), flops=flops_per_step,
                     bytes_moved=2 * n_params * 2)
        msg += f"; per-step {r.summary()}"
    print(msg)
    trainer.close()


if __name__ == "__main__":
    main()
