"""Smoke run of the main path on the GPU: the quickest proof that the
library, the trainer and the serving Engine still start and agree with
their plain references.

    python chip_smoke.py              # one GPU: all one-card phases
    python chip_smoke.py --chips 4    # four GPUs: the multi-card path only
    python chip_smoke.py --rehearse   # CPU, toy widths, kernels interpreted

The model is Llama-3.1-8B at its published widths (`models.llama31_8b`)
with the depth cut to 4 layers (~1.9 B parameters) and random weights from
`--seed`; bf16 comes from the config. One-card phases, in one process:

1. device   — a GPU, its name and power limit (nvidia-smi) and device_kind;
2. kernels  — every Triton kernel against `ops/reference.py` in float32
              under `default_matmul_precision("highest")`, within 2x
              (outputs) / 3x (grads) the error of the low-precision,
              op-reordered oracle plus a stated floor;
3. train    — `ResilientTrainer` steps of the `examples/train.py` step
              (adamw, clip); first-step loss and one gradient against the
              model with reference attention at float32/highest;
4. serve    — `Engine` (paged int8 KV, prefix cache, chunked prefill) on
              requests sharing a prefix, every generated token checked
              against a full float32 recompute with reference attention;
5. gpu tests — the tests marked `gpu`, in this process (`pytest.main`).

Any failed check exits non-zero. With no GPU the script exits non-zero
before printing anything. The last line is one JSON object naming the
device JAX reports.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


class Check:
    """Prints `name: value <= limit` lines and remembers failures."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, value, limit):
        ok = bool(np.isfinite(value)) and value <= limit
        print(f"  {name}: {value:.4g} <= {limit:.4g} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            self.failed.append(name)

    def true(self, name, cond):
        print(f"  {name}: {'ok' if cond else 'FAIL'}", flush=True)
        if not cond:
            self.failed.append(name)


CHECK = Check()


def maxdiff(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def rel_l2(a, b):
    """||a - b|| / ||b|| over whole pytrees, in float32."""
    num = den = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = x.astype(jnp.float32), y.astype(jnp.float32)
        num += float(jnp.sum((x - y) ** 2))
        den += float(jnp.sum(y ** 2))
    return (num / max(den, 1e-30)) ** 0.5


def phase(name):
    def run(fn, *args):
        t0 = time.perf_counter()
        print(f"[{name}]", flush=True)
        fn(*args)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)
    return run


def model_config(rehearse, dtype=jnp.bfloat16):
    from fa2_jax.models import LlamaConfig, llama31_8b

    if rehearse:
        return LlamaConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, hidden_dim=128, rope_theta=500000.0,
                           rope_factors=(8.0, 1.0, 4.0, 8192), dtype=dtype)
    return llama31_8b(n_layers=4, dtype=dtype)


def reference_attention(q, k, v, _kv_len=None):
    from fa2_jax import flash_attn_reference

    return flash_attn_reference(q, k, v, causal=True)


def f32_params(params):
    return jax.tree.map(lambda x: x.astype(jnp.float32), params)


# ------------------------------- kernels ----------------------------------

# Absolute floors added to the FA-style bound, for cases where the
# low-precision oracle happens to land very close to the float32 truth.
OUT_FLOOR, GRAD_FLOOR = 1e-3, 1e-3


def attention_case(name, B, S, Hq, Hkv, D, dtype, *, causal=True,
                   window=(-1, -1), softcap=0.0, bias=False, dropout_p=0.0,
                   lse=False, seed=0):
    from fa2_jax import flash_attn_func, flash_attn_reference
    from fa2_jax.utils.rng import dropout_keep_mask_reference

    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    q = (jax.random.normal(ks[0], (B, S, Hq, D)) * 0.5).astype(dtype)
    k = (jax.random.normal(ks[1], (B, S, Hkv, D)) * 0.5).astype(dtype)
    v = (jax.random.normal(ks[2], (B, S, Hkv, D)) * 0.5).astype(dtype)
    do = jax.random.normal(ks[3], (B, S, Hq, D)).astype(dtype)
    b = (jax.random.normal(ks[4], (1, Hq, S, S)) * 0.5).astype(dtype) \
        if bias else None
    dlse = jax.random.normal(ks[5], (B, Hq, S)) if lse else None
    mask = (dropout_keep_mask_reference(7, dropout_p, B, Hq, S, S)
            if dropout_p > 0 else None)
    kw = dict(causal=causal, window_size=window, softcap=softcap)

    def loss(fn):
        # Everything the loss reads is an argument: a closed-over array would
        # be baked into the program as a constant (slow to compile).
        def f(q, k, v, b, do, dlse, mask):
            out = fn(q, k, v, b, mask)
            o, l = out if lse else (out, None)
            val = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))
            if lse:
                # Both LSEs are base 2; this differentiates through them.
                val = val + jnp.sum(l * dlse)
            return val, o
        return f

    def ours(q, k, v, b, mask):
        del mask  # the kernel regenerates it from the seed
        return flash_attn_func(q, k, v, attention_bias=b, dropout_p=dropout_p,
                               dropout_seed=7, return_lse=lse, **kw)

    def ref(upcast, reorder):
        def f(q, k, v, b, mask):
            return flash_attn_reference(
                q, k, v, attn_bias=b, dropout_p=dropout_p, dropout_mask=mask,
                return_lse=lse, upcast=upcast, reorder_ops=reorder, **kw)
        return f

    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)

    def grads(fn, *args):
        return jax.jit(jax.grad(loss(fn), argnums=argnums, has_aux=True))(
            *args, do, dlse, mask)

    f32 = [x.astype(jnp.float32) if x is not None else None
           for x in (q, k, v, b)]
    g, o = grads(ours, q, k, v, b)
    with jax.default_matmul_precision("highest"):
        g_ref, o_ref = grads(ref(True, False), *f32)
    g_lp, o_lp = grads(ref(False, True), q, k, v, b)
    CHECK(f"{name} out max|d|", maxdiff(o, o_ref),
          2 * maxdiff(o_lp, o_ref) + OUT_FLOOR)
    for gname, x, xr, xl in zip(("dq", "dk", "dv", "dbias"), g, g_ref, g_lp):
        CHECK(f"{name} {gname} max|d|", maxdiff(x, xr),
              3 * maxdiff(xl, xr) + GRAD_FLOOR)


def decode_cases(rehearse):
    from fa2_jax import flash_attn_reference
    from fa2_jax.ops.decode import decode_attention, paged_decode_attention
    from fa2_jax.ops.quant import quantize_tensor

    B, S, Hkv, G, D = (4, 256, 2, 4, 128) if rehearse else (32, 8192, 8, 4, 128)
    page = 16 if rehearse else 128
    Hq = Hkv * G
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    q = (jax.random.normal(ks[0], (B, Hq, D)) * 0.5).astype(jnp.bfloat16)
    k = (jax.random.normal(ks[1], (B, Hkv, S, D)) * 0.5).astype(jnp.bfloat16)
    v = (jax.random.normal(ks[2], (B, Hkv, S, D)) * 0.5).astype(jnp.bfloat16)
    lens = jnp.asarray(np.linspace(S // 3, S, B).astype(np.int32))
    key_mask = jnp.arange(S)[None, :] < lens[:, None]

    def oracle(kd, vd, upcast, reorder):
        # One query row at position len-1 sees every valid key.
        out = flash_attn_reference(
            q[:, None], jnp.swapaxes(kd, 1, 2), jnp.swapaxes(vd, 1, 2),
            key_padding_mask=key_mask, upcast=upcast, reorder_ops=reorder)
        return out[:, 0]

    def to_pages(x):
        n = S // page
        return x.reshape(B, x.shape[1], n, page, x.shape[-1]).transpose(
            0, 2, 1, 3, 4).reshape(B * n, x.shape[1], page, x.shape[-1])

    tables = jnp.arange(B * (S // page), dtype=jnp.int32).reshape(B, S // page)
    for qdtype in (None, jnp.int8, jnp.float8_e4m3fn):
        if qdtype is None:
            kc, vc, ksc, vsc = k, v, None, None
            kd, vd = k, v
        else:
            kc, ksc = quantize_tensor(k, qdtype)
            vc, vsc = quantize_tensor(v, qdtype)
            kd = (kc.astype(jnp.float32) * ksc).astype(jnp.bfloat16)
            vd = (vc.astype(jnp.float32) * vsc).astype(jnp.bfloat16)
            ksc, vsc = jnp.swapaxes(ksc, 2, 3), jnp.swapaxes(vsc, 2, 3)
        with jax.default_matmul_precision("highest"):
            o_ref = oracle(kd.astype(jnp.float32), vd.astype(jnp.float32),
                           True, False)
        lim = 2 * maxdiff(oracle(kd, vd, False, True), o_ref) + OUT_FLOOR
        name = "bf16" if qdtype is None else jnp.dtype(qdtype).name
        o = jax.jit(decode_attention)(q, kc, vc, lens, ksc, vsc)
        CHECK(f"decode {name} contiguous max|d|", maxdiff(o, o_ref), lim)
        pk = None if ksc is None else to_pages(jnp.swapaxes(ksc, 2, 3))
        pv = None if vsc is None else to_pages(jnp.swapaxes(vsc, 2, 3))
        o = jax.jit(paged_decode_attention)(
            q, to_pages(kc), to_pages(vc), tables, lens,
            None if pk is None else jnp.swapaxes(pk, 2, 3),
            None if pv is None else jnp.swapaxes(pv, 2, 3))
        CHECK(f"decode {name} paged max|d|", maxdiff(o, o_ref), lim)


def phase_kernels(rehearse):
    if rehearse:
        big = dict(B=1, S=256, Hq=4, Hkv=2, D=64)
        mid = dict(B=1, S=128, Hq=4, Hkv=2, D=64)
    else:
        big = dict(B=2, S=4096, Hq=32, Hkv=8, D=128)
        mid = dict(B=2, S=2048, Hq=32, Hkv=8, D=128)
    bf = jnp.bfloat16
    attention_case("causal", **big, dtype=bf, causal=True)
    attention_case("dense", **big, dtype=bf, causal=False)
    attention_case("window+softcap", **mid, dtype=bf,
                   window=(mid["S"] // 8, 0), softcap=30.0)
    attention_case("bias", **mid, dtype=bf, bias=True)
    attention_case("dropout", **mid, dtype=bf, dropout_p=0.1)
    attention_case("return_lse", **mid, dtype=bf, lse=True)
    attention_case("fp16", **mid, dtype=jnp.float16)
    attention_case("fp32", **mid, dtype=jnp.float32)
    decode_cases(rehearse)


# -------------------------------- train -----------------------------------

def phase_train(rehearse, seed):
    from examples.train import make_optimizer, make_step_fn
    from fa2_jax.models import init_params, loss_fn
    from fa2_jax.utils.resilience import ResilientTrainer

    cfg = model_config(rehearse)
    B, S = (2, 64) if rehearse else (4, 2048)
    params = init_params(jax.random.PRNGKey(seed), cfg)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"  model: {n_params / 1e9:.3f} B parameters, {cfg.n_layers} layers")
    rng = np.random.RandomState(seed)
    batches = [jnp.asarray(rng.randint(0, cfg.vocab_size, (B, S)), jnp.int32)
               for _ in range(3)]

    # One gradient of the bf16 flash model against the float32 model with
    # reference attention, at batch 1 (the float32 reference's memory).
    tok1 = batches[0][:1]
    g = jax.jit(jax.grad(lambda p, t: loss_fn(p, t, cfg)))(params, tok1)
    cfg32 = model_config(rehearse, jnp.float32)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.jit(jax.grad(lambda p, t: loss_fn(
            p, t, cfg32, reference_attention)))(f32_params(params), tok1)
    # bf16 weights and activations: ~2^-8 relative per operation.
    CHECK("train grad rel-L2 (bf16 vs f32 reference)", rel_l2(g, g_ref), 5e-2)
    del g, g_ref

    opt = make_optimizer()
    state = {"params": params, "opt": opt.init(params), "step": jnp.int32(0)}
    ckpt = os.path.join(REPO, ".ckpt", "chip_smoke")
    shutil.rmtree(ckpt, ignore_errors=True)
    trainer = ResilientTrainer(make_step_fn(cfg, opt, loss_fn), ckpt,
                               save_every=10 ** 9)
    losses = []
    for b in batches:
        state = trainer.run(state, [b], start_step=len(losses),
                            final_save=False)
        losses.append(trainer.report.last_loss)
    trainer.close()
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  losses: {losses}")
    CHECK.true("train losses finite", all(np.isfinite(losses)))
    CHECK.true("train steps applied", trainer.report.steps_run == 3
               and trainer.report.steps_skipped == 0)
    with jax.default_matmul_precision("highest"):
        ref_loss = float(jax.jit(lambda p, t: loss_fn(
            p, t, cfg32, reference_attention))(f32_params(params), batches[0]))
    CHECK("train first-step loss |d| (vs f32 reference)",
          abs(losses[0] - ref_loss), 2e-3 * abs(ref_loss))


# -------------------------------- serve -----------------------------------

def phase_serve(rehearse, seed):
    from fa2_jax.models import forward, init_params
    from fa2_jax.runtime import Engine

    cfg = model_config(rehearse)
    params = init_params(jax.random.PRNGKey(seed + 1), cfg)
    prefix_len, page, chunk = (48, 16, 32) if rehearse else (768, 128, 256)
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, prefix_len).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size,
                                    rng.randint(16, 3 * page)).tolist()
               for _ in range(5)]
    new_tokens = 8 if rehearse else 16
    eng = Engine(params, cfg, n_slots=4, max_seq=2048 if not rehearse else 256,
                 qdtype=jnp.int8, paged=True, prefix_cache=True,
                 page_size=page, prefill_chunk=chunk)
    # The first request registers the shared prefix pages; the rest hit them.
    reqs = [eng.submit(prompts[0], new_tokens)]
    eng.run()
    reqs += [eng.submit(p, new_tokens) for p in prompts[1:]]
    stats = eng.run()
    print(f"  {len(reqs)} requests, {stats.prefix_cached_tokens} prompt tokens"
          f" from the prefix cache, {stats.decode_tokens} decode tokens")
    CHECK.true("serve all requests answered",
               all(len(r.out_tokens) == new_tokens for r in reqs))
    CHECK.true("serve prefix cache hit", stats.prefix_cached_tokens > 0)

    # Reference: full float32 recompute with reference attention over the
    # prompt plus the generated tokens (teacher-forced). bf16 weights and
    # the int8 KV cache make exact token equality unfair on near-ties, so
    # each generated token must be within TOL nats of the reference argmax
    # and carry the reference's logprob within TOL.
    TOL = 0.25
    cfg32 = model_config(rehearse, jnp.float32)
    p32 = f32_params(params)
    fwd = jax.jit(lambda p, t: jax.nn.log_softmax(
        forward(p, t, cfg32, reference_attention), axis=-1))
    worst_gap = worst_lp = 0.0
    for r in reqs:
        seq = jnp.asarray([r.prompt + r.out_tokens[:-1]], jnp.int32)
        with jax.default_matmul_precision("highest"):
            logp = np.asarray(fwd(p32, seq)[0, len(r.prompt) - 1:])
        for i, tok in enumerate(r.out_tokens):
            worst_gap = max(worst_gap, float(logp[i].max() - logp[i, tok]))
            worst_lp = max(worst_lp, abs(float(logp[i, tok])
                                         - r.out_logprobs[i]))
    CHECK("serve token gap to reference argmax (nats)", worst_gap, TOL)
    CHECK("serve logprob |d| vs reference (nats)", worst_lp, TOL)


# ------------------------------ gpu tests ---------------------------------

def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    CHECK.true("pytest -m gpu", rc == 0)


# ------------------------------ four cards --------------------------------

def phase_multichip(rehearse, seed):
    """The multi-card path, each part against its one-card counterpart:
    a TP=2 x DP=2 train step, ring attention fwd+bwd, TP serving tokens and
    an FSDP step. The mesh follows the algorithm (NVLink joins the cards
    all to all); shardings are checked to span every card."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fa2_jax import flash_attn_func
    from fa2_jax.models import init_params, loss_fn
    from fa2_jax.parallel import (
        fsdp_param_pspecs, make_mesh, make_ring_attention, make_tp_attention,
        shard_params,
    )
    from fa2_jax.runtime.serving import Engine

    devs = jax.devices()[:4]
    cfg = model_config(rehearse)
    params = init_params(jax.random.PRNGKey(seed), cfg)
    B, S = (4, 64) if rehearse else (4, 2048)
    tokens = jnp.asarray(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)), jnp.int32)
    opt = optax.adamw(1e-4)

    def step(attention_fn):
        def f(params, opt_state, tokens):
            loss, grads = jax.value_and_grad(
                lambda p: loss_fn(p, tokens, cfg, attention_fn))(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss
        return jax.jit(f)

    one_loss = float(step(None)(params, opt.init(params), tokens)[2])

    # TP=2 x DP=2.
    mesh = make_mesh(data=2, model=2, devices=devs)
    tp_params = shard_params(params, mesh)
    wq = tp_params["layers"][0]["wq"]
    CHECK.true("tp x dp: weights span 4 cards",
               len(wq.sharding.device_set) == 4
               and not wq.sharding.is_fully_replicated)
    tp_attn = make_tp_attention(mesh, causal=True)
    with mesh:
        _, _, tp_loss = step(lambda q, k, v, _: tp_attn(q, k, v))(
            tp_params, opt.init(tp_params),
            jax.device_put(tokens, NamedSharding(mesh, P("data", None))))
    CHECK("tp2 x dp2 train loss |d| vs one card", abs(float(tp_loss) - one_loss),
          5e-3 * abs(one_loss))
    del tp_params

    # FSDP over 4 cards.
    fmesh = make_mesh(data=4, devices=devs)
    specs = fsdp_param_pspecs(params, fmesh)
    f_params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(fmesh, s)), params, specs)
    with fmesh:
        f_params2, _, f_loss = step(None)(
            f_params, opt.init(f_params),
            jax.device_put(tokens, NamedSharding(fmesh, P("data", None))))
    w = max(jax.tree_util.tree_leaves(f_params2), key=lambda x: x.size)
    CHECK.true("fsdp: updated weights stay sharded over 4 cards",
               len(w.sharding.device_set) == 4
               and not w.sharding.is_fully_replicated)
    CHECK("fsdp4 train loss |d| vs one card", abs(float(f_loss) - one_loss),
          5e-3 * abs(one_loss))
    del f_params, f_params2

    # Ring attention (seq=4) forward+backward vs the one-card kernel.
    Sr, Hq, Hkv, D = (512, 4, 2, 64) if rehearse else (32768, 32, 8, 128)
    rmesh = make_mesh(seq=4, devices=devs)
    ks = jax.random.split(jax.random.PRNGKey(seed + 2), 4)
    q = (jax.random.normal(ks[0], (1, Sr, Hq, D)) * 0.5).astype(jnp.bfloat16)
    k = (jax.random.normal(ks[1], (1, Sr, Hkv, D)) * 0.5).astype(jnp.bfloat16)
    v = (jax.random.normal(ks[2], (1, Sr, Hkv, D)) * 0.5).astype(jnp.bfloat16)
    do = jax.random.normal(ks[3], (1, Sr, Hq, D)).astype(jnp.bfloat16)

    def fwd_bwd(fn):
        def f(q, k, v, do):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o,) + vjp(do)
        return jax.jit(f)

    ring = make_ring_attention(rmesh, causal=True)
    spec = NamedSharding(rmesh, P("data", "seq", "model", None))
    with rmesh:
        r_out = fwd_bwd(ring)(*(jax.device_put(x, spec) for x in (q, k, v, do)))
    CHECK.true("ring: q shards span 4 cards",
               len(r_out[1].sharding.device_set) == 4)
    one_out = fwd_bwd(lambda q, k, v: flash_attn_func(q, k, v, causal=True))(
        q, k, v, do)
    # bf16 outputs of two summation orders: rounding-level differences.
    for name, a, b in zip(("out", "dq", "dk", "dv"), r_out, one_out):
        CHECK(f"ring S={Sr} {name} rel-L2 vs one card", rel_l2(a, b), 1e-2)
    del r_out, one_out

    # TP=2 serving vs one card, in float32 at highest precision so the
    # summation order cannot flip a greedy near-tie.
    cfg32 = model_config(rehearse, jnp.float32)
    p32 = f32_params(params)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13]]

    def generate(m):
        eng = Engine(p32, cfg32, n_slots=2, max_seq=128, mesh=m)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        return [r.out_tokens for r in reqs]

    with jax.default_matmul_precision("highest"):
        tp_toks = generate(make_mesh(model=2, devices=devs[:2]))
        one_toks = generate(None)
    print(f"  tp serving tokens {tp_toks}")
    CHECK.true("tp2 serving tokens == one card", tp_toks == one_toks)


# --------------------------------- main -----------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at toy widths (no result line)")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(jax.devices())} devices", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from fa2_jax.utils import enable_compile_cache

    enable_compile_cache()
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}",
          flush=True)

    if args.chips == 4:
        phase("multichip")(phase_multichip, args.rehearse, args.seed)
    else:
        phase("kernels")(phase_kernels, args.rehearse)
        phase("train")(phase_train, args.rehearse, args.seed)
        phase("serve")(phase_serve, args.rehearse, args.seed)
        if not args.rehearse:
            phase("gpu tests")(phase_gpu_tests)
    if CHECK.failed:
        print(f"chip_smoke: FAILED {CHECK.failed}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (no device result)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
