"""Serving throughput demo: continuous-batched greedy decode on the GPU.

Measures end-to-end engine tokens/s (the BASELINE.json serving metric) on a
LLaMA-style model sized to be attention/matmul-bound rather than
dispatch-bound.

Usage:
  python -m fa2_jax.runtime.serving_demo                # bf16 KV
  python -m fa2_jax.runtime.serving_demo --qdtype int8  # int8 KV
  python -m fa2_jax.runtime.serving_demo --dim 1024 --layers 8
  python -m fa2_jax.runtime.serving_demo --tp 2         # TP engine
    (tensor-parallel over the model axis; needs >= tp devices — on multi-device
    hardware this is the BASELINE 1 -> N host tokens/s scaling measurement)
"""
from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from fa2_jax.models import LlamaConfig, init_params
from fa2_jax.runtime import Engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qdtype", default=None, choices=[None, "int8", "fp8"])
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (model-axis mesh)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (shared page pool)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching (implies --paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request a common prompt prefix of this "
                         "many tokens (prefix-cache workload)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (paged mode); only full pages are "
                         "prefix-shareable, so keep <= --shared-prefix")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="model dtype")
    args = ap.parse_args()

    from fa2_jax.utils import enable_compile_cache

    enable_compile_cache()
    qdtype = {None: None, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[args.qdtype]
    cfg = LlamaConfig(
        vocab_size=32000, dim=args.dim, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads,
        hidden_dim=int(args.dim * 2.75) // 128 * 128,
        max_seq_len=args.max_seq,
        dtype=jnp.dtype(args.dtype),
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = None
    if args.tp > 1:
        from fa2_jax.parallel.mesh import make_mesh

        mesh = make_mesh(model=args.tp, devices=jax.devices()[: args.tp])
    eng = Engine(params, cfg, n_slots=args.slots, max_seq=args.max_seq,
                 qdtype=qdtype, mesh=mesh,
                 paged=args.paged or args.prefix_cache,
                 prefix_cache=args.prefix_cache,
                 page_size=args.page_size or
                 (128 if args.prefix_cache else None))

    rng = np.random.RandomState(0)
    shared = rng.randint(0, cfg.vocab_size, size=args.shared_prefix).tolist()
    for _ in range(args.requests):
        plen = rng.randint(args.prompt_len // 2, args.prompt_len + 1)
        eng.submit(shared + rng.randint(0, cfg.vocab_size, size=plen).tolist(),
                   max_new_tokens=args.new_tokens)

    # Warm the jit caches (every prefill bucket + the decode step) on
    # throwaway requests so the measured drain excludes compile time.
    from fa2_jax.runtime.serving import EngineStats

    pending = list(eng.queue)
    eng.queue = []
    seen = set()
    for r in pending:
        bucket = max(64, 1 << (len(r.prompt) - 1).bit_length())
        if bucket not in seen:
            seen.add(bucket)
            eng.submit([1] * len(r.prompt), max_new_tokens=2)
    eng.run()
    eng.queue = pending
    eng.stats = EngineStats()

    stats = eng.run()
    print(
        f"prefill {stats.prefill_tokens} tok "
        f"(+{stats.prefix_cached_tokens} from prefix cache), "
        f"decode {stats.decode_tokens} tok "
        f"in {stats.wall_s:.2f}s over {stats.decode_steps} steps",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "serving_decode_tokens_per_s"
                  + (f"_{args.qdtype}" if args.qdtype else ""),
        "value": round(stats.decode_tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        # The device the number was measured on (a CPU run is no GPU result).
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
