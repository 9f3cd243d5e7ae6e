"""Benchmark driver — reference protocol (B=4, H=32, S=4096, D=128,
fwd-only, `/root/reference/benchmarks/targetted_bench.py:11-19`) on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline = speedup over XLA's native (dense, unfused) attention on the
same device — the analog of the reference's "Pytorch" comparison kernel
(`benchmarks/utils.py:24`). The line also names the device it ran on; with
no GPU the script exits non-zero and prints no result.

Timing uses `fa2_jax.utils.benchmarking.device_time`: host time around
`block_until_ready` after a warm-up call.

Usage:
  python bench.py                    # headline: fwd bf16 non-causal S=4096
  python bench.py --suite            # full table to stderr + headline JSON
  python bench.py --mode fwdbwd
  python bench.py --mode decode      # int8-KV decode tokens/s vs bf16 cache
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import jax
import jax.numpy as jnp

from fa2_jax.utils import enable_compile_cache
from fa2_jax.utils.benchmarking import device_time


def attention_flops(B, Hq, Sq, Sk, D, causal, fwd_and_bwd=False):
    f = 4 * B * Hq * Sq * Sk * D
    if causal:
        f /= 2
    return f * (1 + 2.5) if fwd_and_bwd else f


def make_inputs(B, Sq, Sk, Hq, Hkv, D, dtype, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, Sq, Hq, D), dtype) * 0.5
    k = jax.random.normal(ks[1], (B, Sk, Hkv, D), dtype) * 0.5
    v = jax.random.normal(ks[2], (B, Sk, Hkv, D), dtype) * 0.5
    return q, k, v


# Dense unfused attention — the 'PyTorch oracle' analog baseline.
from fa2_jax.other_implementations import xla_attention as xla_native_attention  # noqa: E402


def bench_attention(B, S, Hq, Hkv, D, dtype, causal, mode, baseline=True):
    from fa2_jax import flash_attn_func

    q, k, v = make_inputs(B, S, S, Hq, Hkv, D, dtype)
    if mode == "fwd":
        ours = functools.partial(flash_attn_func, causal=causal)
        base = functools.partial(xla_native_attention, causal=causal)
        t_ours = device_time(ours, q, k, v)
        t_base = device_time(base, q, k, v) if baseline else t_ours
        flops = attention_flops(B, Hq, S, S, D, causal)
    else:
        do = jax.random.normal(jax.random.PRNGKey(7), q.shape, dtype)

        def with_grad(attn):
            def fn(q, k, v, do):
                out, vjp = jax.vjp(attn, q, k, v)
                return (out,) + vjp(do)
            return fn

        t_ours = device_time(
            with_grad(functools.partial(flash_attn_func, causal=causal)),
            q, k, v, do)
        t_base = device_time(
            with_grad(functools.partial(xla_native_attention, causal=causal)),
            q, k, v, do) if baseline else t_ours
        flops = attention_flops(B, Hq, S, S, D, causal, fwd_and_bwd=True)
    return {
        "ms": t_ours * 1e3, "baseline_ms": t_base * 1e3,
        "tflops": flops / t_ours / 1e12, "speedup": t_base / t_ours,
    }


def bench_decode(B=32, Hq=32, Hkv=8, D=128, S_max=8192, fill=8192):
    """Single decode step over an int8 KV cache vs bf16 cache (bandwidth
    roof: quantization should approach 2x)."""
    from fa2_jax.ops.decode import decode_attention
    from fa2_jax.ops.quant import quantize_tensor

    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (B, Hq, D), jnp.bfloat16) * 0.5
    k = jax.random.normal(ks[1], (B, Hkv, S_max, D), jnp.bfloat16) * 0.5
    v = jax.random.normal(ks[2], (B, Hkv, S_max, D), jnp.bfloat16) * 0.5
    lens = jnp.full((B,), fill, jnp.int32)

    t_bf16 = device_time(
        lambda q, k, v: decode_attention(q, k, v, lens), q, k, v)
    kq, ksc = quantize_tensor(k, jnp.int8)
    vq, vsc = quantize_tensor(v, jnp.int8)
    # decode_attention takes scales transposed: [B, H, S, 1] -> [B, H, 1, S].
    ksc = jnp.swapaxes(ksc, 2, 3)
    vsc = jnp.swapaxes(vsc, 2, 3)
    t_int8 = device_time(
        lambda q, kq, vq: decode_attention(q, kq, vq, lens, ksc, vsc),
        q, kq, vq)
    # FP8 KV (e4m3): same 1 byte/elem stream as int8, different dequant.
    kq8, ksc8 = quantize_tensor(k, jnp.float8_e4m3fn)
    vq8, vsc8 = quantize_tensor(v, jnp.float8_e4m3fn)
    ksc8 = jnp.swapaxes(ksc8, 2, 3)
    vsc8 = jnp.swapaxes(vsc8, 2, 3)
    t_fp8 = device_time(
        lambda q, kq, vq: decode_attention(q, kq, vq, lens, ksc8, vsc8),
        q, kq8, vq8)
    # Each step streams the live KV bytes once.
    bytes_bf16 = 2 * B * Hkv * fill * D * 2
    bytes_int8 = 2 * B * Hkv * fill * (D * 1 + 4)
    return {
        "bf16_ms": t_bf16 * 1e3, "int8_ms": t_int8 * 1e3,
        "fp8_ms": t_fp8 * 1e3,
        "bf16_gbps": bytes_bf16 / t_bf16 / 1e9,
        "int8_gbps": bytes_int8 / t_int8 / 1e9,
        "fp8_gbps": bytes_int8 / t_fp8 / 1e9,
        "tokens_per_s_int8": B / t_int8,
        "tokens_per_s_fp8": B / t_fp8,
        "speedup": t_bf16 / t_int8,
        "speedup_fp8": t_bf16 / t_fp8,
    }


def bench_varlen(B=4, S=4096, Hq=32, Hkv=32, D=128):
    """Lens-driven block skipping: a batch padded ~2x should cost ~half the
    dense-padded time, not the same (reference early-exit parity,
    `/root/reference/src/forward/kernel.py:105-112`)."""
    from fa2_jax import flash_attn_func

    q, k, v = make_inputs(B, S, S, Hq, Hkv, D, jnp.bfloat16)
    # Half of every sequence is padding.
    mask = jnp.arange(S)[None, :] < jnp.full((B, 1), S // 2)
    full = jnp.ones((B, S), bool)
    t_half = device_time(
        lambda q, k, v: flash_attn_func(q, k, v, attention_mask=mask),
        q, k, v)
    t_full = device_time(
        lambda q, k, v: flash_attn_func(q, k, v, attention_mask=full),
        q, k, v)

    # Packed zero-waste mode (ops/varlen.py): the same 50%-real-token batch
    # packed back-to-back — the work list contains only live blocks, so the
    # ideal speedup (~2x) is reachable, unlike the fixed per-grid-step cost
    # the lens-clamp path pays on skipped blocks.
    from fa2_jax import flash_attn_varlen_func, pack_padded_batch

    lens = [S // 2] * B
    (qp, kp, vp), starts, T = pack_padded_batch(
        [q, k, v], lens, align=2048)
    cu = list(starts) + [T]
    t_packed = device_time(
        lambda qp, kp, vp: flash_attn_varlen_func(
            qp, kp, vp, cu, seqlens=lens, block_q=512, block_kv=512),
        qp, kp, vp)
    return {"half_ms": t_half * 1e3, "full_ms": t_full * 1e3,
            "skip_speedup": t_full / t_half,
            "packed_ms": t_packed * 1e3,
            "packed_speedup": t_full / t_packed}


def bench_window(B=1, S=16384, W=4096, Hq=16, D=128):
    """Sliding-window prefill at O(S*W) compute: blocks strictly left of the
    window never enter the banded grid (`ops/flash_fwd.py` first_kv_block_fn
    + band dimension), so a Mistral-style W=4096 prefill at S=16384 should
    cost ~= the attended-pair fraction of the causal time, not O(S^2).
    Window semantics source: `/root/reference/src/reference_implementation.py:8-35`."""
    from fa2_jax import flash_attn_func

    q, k, v = make_inputs(B, S, S, Hq, Hq, D, jnp.bfloat16)
    do = jax.random.normal(jax.random.PRNGKey(7), q.shape, jnp.bfloat16)

    def grad_fn(attn):
        def fn(q, k, v, do):
            out, vjp = jax.vjp(attn, q, k, v)
            return (out,) + vjp(do)
        return fn

    win = functools.partial(flash_attn_func, causal=True, window_size=(W, 0))
    cau = functools.partial(flash_attn_func, causal=True)
    t_win = device_time(win, q, k, v)
    t_cau = device_time(cau, q, k, v)
    t_win_bwd = device_time(grad_fn(win), q, k, v, do)
    t_cau_bwd = device_time(grad_fn(cau), q, k, v, do)
    # Attended pairs: triangle head (rows < W) + band body.
    pairs = W * (W + 1) // 2 + (S - W) * (W + 1)
    flops = 4 * B * Hq * pairs * D
    return {
        "win_ms": t_win * 1e3, "causal_ms": t_cau * 1e3,
        "win_bwd_ms": t_win_bwd * 1e3, "causal_bwd_ms": t_cau_bwd * 1e3,
        "speedup": t_cau / t_win,
        "speedup_bwd": t_cau_bwd / t_win_bwd,
        "ideal": (S * S / 2) / pairs,
        "tflops": flops / t_win / 1e12,
        "tflops_bwd": flops * 3.5 / t_win_bwd / 1e12,
    }


def bench_serve(requests=32, prompt_len=256, new_tokens=128, dim=1024,
                layers=8, heads=8, kv_heads=2, slots=16, max_seq=4096):
    """Engine-level tokens/s: N mixed-length requests through the
    continuous-batching Engine (paged KV + prefix cache + chunked prefill) —
    the single-device anchor for BASELINE's serving-scaling target. Protocol
    analog: `/root/reference/benchmarks/utils.py:92-93` at engine level.

    Reports decode tokens/s with chunked prefill interleaving ON (production
    mode: long prompts never stall decodes) and OFF (whole-prompt prefill),
    so the interleaving overhead is visible."""
    import numpy as np

    from fa2_jax.models import LlamaConfig, init_params
    from fa2_jax.runtime import Engine
    from fa2_jax.runtime.serving import EngineStats

    cfg = LlamaConfig(
        vocab_size=32000, dim=dim, n_layers=layers, n_heads=heads,
        n_kv_heads=kv_heads, hidden_dim=int(dim * 2.75) // 128 * 128,
        max_seq_len=max_seq, dtype=jnp.bfloat16,
    )
    params = init_params(jax.random.PRNGKey(0), cfg)

    def run(chunked: bool):
        eng = Engine(params, cfg, n_slots=slots, max_seq=max_seq,
                     paged=True, prefix_cache=True, page_size=128,
                     prefill_chunk=256 if chunked else None)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size,
                               size=rng.randint(prompt_len // 2,
                                                prompt_len + 1)).tolist()
                   for _ in range(requests)]
        # Warm every jit bucket on throwaway requests, then measure a clean
        # drain (compile time excluded, like serving_demo).
        seen = set()
        for p in prompts:
            bucket = max(64, 1 << (len(p) - 1).bit_length())
            if bucket not in seen:
                seen.add(bucket)
                eng.submit([1] * len(p), max_new_tokens=2)
        eng.run()
        eng.stats = EngineStats()
        for p in prompts:
            eng.submit(p, max_new_tokens=new_tokens)
        return eng.run()

    s_chunk = run(True)
    s_whole = run(False)
    return {
        "decode_tokens_per_s": s_chunk.decode_tokens_per_s,
        "decode_tokens_per_s_whole_prefill": s_whole.decode_tokens_per_s,
        "interleave_overhead": 1.0 - (s_chunk.decode_tokens_per_s
                                      / max(s_whole.decode_tokens_per_s, 1e-9)),
        "prefill_tokens": s_chunk.prefill_tokens,
        "decode_tokens": s_chunk.decode_tokens,
        "wall_s": s_chunk.wall_s,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", action="store_true")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--mode", default="fwd",
                    choices=["fwd", "fwdbwd", "decode", "varlen", "serve",
                             "window"])
    ap.add_argument("--details", action="store_true", default=None,
                    help="append causal fwd+bwd sub-metrics to the headline "
                         "JSON (default: on for the plain headline run)")
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=32)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU; no GPU found")
    enable_compile_cache()

    if args.mode == "varlen":
        r = bench_varlen()
        print(f"varlen 50% padding: lens-clamp {r['half_ms']:.3f} ms / "
              f"packed {r['packed_ms']:.3f} ms vs dense "
              f"{r['full_ms']:.3f} ms "
              f"(skip {r['skip_speedup']:.2f}x, packed "
              f"{r['packed_speedup']:.2f}x)", file=sys.stderr)
        print(json.dumps({
            "metric": "varlen_half_padding_packed_speedup",
            "value": round(r["packed_speedup"], 3),
            "unit": "x",
            "vs_baseline": round(r["packed_speedup"], 3),
        }))
        return

    if args.mode == "window":
        r = bench_window()
        print(f"window W=4096 S=16384: fwd {r['win_ms']:.3f} ms vs causal "
              f"{r['causal_ms']:.3f} ms ({r['speedup']:.2f}x, ideal "
              f"{r['ideal']:.2f}x, {r['tflops']:.1f} eff TFLOP/s); "
              f"fwd+bwd {r['win_bwd_ms']:.3f} ms vs {r['causal_bwd_ms']:.3f} "
              f"ms ({r['speedup_bwd']:.2f}x, {r['tflops_bwd']:.1f} eff)",
              file=sys.stderr)
        print(json.dumps({
            "metric": "window_W4096_S16384_fwd_speedup_vs_causal",
            "value": round(r["speedup"], 3),
            "unit": "x",
            "vs_baseline": round(r["speedup"] / r["ideal"], 3),
            "details": {
                "fwd_eff_tflops": round(r["tflops"], 1),
                "fwdbwd_speedup": round(r["speedup_bwd"], 3),
                "fwdbwd_eff_tflops": round(r["tflops_bwd"], 1),
            },
        }))
        return

    if args.mode == "decode":
        r = bench_decode()
        print(f"decode: bf16 {r['bf16_ms']:.3f} ms ({r['bf16_gbps']:.0f} GB/s), "
              f"int8 {r['int8_ms']:.3f} ms ({r['int8_gbps']:.0f} GB/s), "
              f"fp8 {r['fp8_ms']:.3f} ms ({r['fp8_gbps']:.0f} GB/s)",
              file=sys.stderr)
        print(json.dumps({
            "metric": "decode_tokens_per_s_int8kv_S8192",
            "value": round(r["tokens_per_s_int8"], 1),
            "unit": "tokens/s",
            "vs_baseline": round(r["speedup"], 3),
            "details": {
                "fp8_tokens_per_s": round(r["tokens_per_s_fp8"], 1),
                "fp8_vs_bf16": round(r["speedup_fp8"], 3),
            },
        }))
        return

    if args.mode == "serve":
        r = bench_serve()
        print(f"serve: {r['decode_tokens']} decode tok in {r['wall_s']:.2f}s "
              f"(chunked-prefill {r['decode_tokens_per_s']:.0f} tok/s, "
              f"whole-prefill {r['decode_tokens_per_s_whole_prefill']:.0f} "
              f"tok/s, interleave overhead "
              f"{100*r['interleave_overhead']:.1f}%)", file=sys.stderr)
        print(json.dumps({
            "metric": "serving_decode_tokens_per_s_156M",
            "value": round(r["decode_tokens_per_s"], 1),
            "unit": "tokens/s",
            "vs_baseline": 1.0,
            "details": {
                "whole_prefill_tokens_per_s":
                    round(r["decode_tokens_per_s_whole_prefill"], 1),
                "prefill_interleave_overhead":
                    round(r["interleave_overhead"], 4),
            },
        }))
        return

    if args.suite:
        for causal in (False, True):
            for mode in ("fwd", "fwdbwd"):
                for S in (1024, 2048, 4096, 8192):
                    r = bench_attention(4, S, 32, 32, 128, jnp.bfloat16, causal, mode)
                    print(f"causal={causal} {mode} S={S}: {r['ms']:.3f} ms "
                          f"{r['tflops']:.1f} TFLOP/s (baseline {r['baseline_ms']:.3f} ms, "
                          f"{r['speedup']:.2f}x)", file=sys.stderr, flush=True)

    # The dense baseline materializes per-head [B, S, S] fp32 scores; at
    # very long sequences it cannot run on one device, so vs_baseline is
    # reported as 0 (= not measured).
    with_base = args.batch * args.seqlen * args.seqlen * 4 < 12e9
    r = bench_attention(args.batch, args.seqlen, args.heads, args.heads, 128,
                        jnp.bfloat16, args.causal, args.mode,
                        baseline=with_base)
    if not with_base:
        r["speedup"] = 0.0
    line = {
        "metric": f"attn_{args.mode}_tflops_per_s_S{args.seqlen}"
                  + ("_causal" if args.causal else ""),
        "value": round(r["tflops"], 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(r["speedup"], 3),
    }
    # The plain headline also carries the causal training rows.
    details = args.details
    if details is None:
        details = (args.mode == "fwd" and not args.causal
                   and args.seqlen == 4096 and not args.suite)
    if details:
        rc4 = bench_attention(4, 4096, 32, 32, 128, jnp.bfloat16, True,
                              "fwdbwd", baseline=False)
        rc1 = bench_attention(4, 1024, 32, 32, 128, jnp.bfloat16, True,
                              "fwdbwd", baseline=False)
        line["details"] = {
            "causal_fwdbwd_tflops_S4096": round(rc4["tflops"], 2),
            "causal_fwdbwd_tflops_S1024": round(rc1["tflops"], 2),
        }
    dev = jax.devices()[0]
    line["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
