"""HuggingFace checkpoint conversion: `transformers` Llama -> param pytree.

The bridge that lets real checkpoints run on this framework's kernels: map
a `LlamaForCausalLM` state dict onto `models/llama.py`'s pytree (and config)
so training, serving, quantization, and every sharding path work on
published weights. Conventions line up directly:

- torch Linear stores [out, in]; our matmuls are x @ W with W [in, out] —
  every projection transposes.
- HF rotary is the split-half ("rotate_half") form with
  `inv_freq = theta^(-2i/d)` — exactly `llama.py:rope_cos_sin/apply_rope`.
- HF q/k/v projections emit head-major rows; our [B, S, H, hd] reshape
  reads the output dim head-major — no permutation needed (incl. GQA).

Verified end to end by `tests/test_convert.py`: logits parity vs the
`transformers` forward on random tiny configs (MHA + GQA).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np

from fa2_jax.models.llama import LlamaConfig

Params = Dict[str, Any]


def _t(x, dtype) -> jnp.ndarray:
    """torch tensor / array -> transposed jnp array (Linear [out,in] -> [in,out])."""
    return jnp.asarray(np.asarray(x, np.float32).T).astype(dtype)


def _a(x, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _rope_factors_from_hf(hf_config):
    """HF `rope_scaling` dict -> LlamaConfig.rope_factors tuple (Llama-3.x
    NTK-by-parts). None passes through; anything else unsupported raises
    LOUDLY — silently ignoring scaling would load long-context checkpoints
    with wrong positional geometry."""
    rs = getattr(hf_config, "rope_scaling", None)
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind == "default":
        return None
    if kind != "llama3":
        raise NotImplementedError(f"unsupported rope_scaling type: {kind!r}")
    return (float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]))


def _window_pattern_from_hf(hf_config):
    """Per-layer sliding flags. Qwen2's first `max_window_layers` layers run
    FULL attention even when use_sliding_window=True (HF `layer_types`);
    None when every layer is uniform (the common case)."""
    if not (getattr(hf_config, "sliding_window", None)
            and getattr(hf_config, "use_sliding_window", True)):
        return None
    lt = getattr(hf_config, "layer_types", None)
    if lt is not None:
        pattern = tuple(t == "sliding_attention" for t in lt)
    else:
        mwl = getattr(hf_config, "max_window_layers",
                      hf_config.num_hidden_layers)
        pattern = tuple(i >= mwl
                        for i in range(hf_config.num_hidden_layers))
    return None if all(pattern) else pattern


def llama_config_from_hf(hf_config, dtype=jnp.float32) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        hidden_dim=hf_config.intermediate_size,
        head_dim=getattr(hf_config, "head_dim", None)
        or hf_config.hidden_size // hf_config.num_attention_heads,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rope_factors=_rope_factors_from_hf(hf_config),
        norm_eps=float(hf_config.rms_norm_eps),
        max_seq_len=hf_config.max_position_embeddings,
        dtype=dtype,
        # Qwen2 carries additive q/k/v biases (LlamaConfig.attention_bias is
        # the HF flag when present; Qwen2's architecture implies them and is
        # detected from the state dict in llama_params_from_hf).
        qkv_bias=bool(getattr(hf_config, "attention_bias", False)),
        # Mistral/Qwen2 sliding-window attention. Qwen2 gates it behind
        # use_sliding_window (default off); Mistral applies it whenever set.
        # OFF-BY-ONE: HF's sliding_window counts the attending token itself
        # (kv_idx > q_idx - sw), ours counts PREVIOUS tokens (window_left),
        # so HF sw == ours sw - 1.
        sliding_window=(
            int(hf_config.sliding_window) - 1
            if getattr(hf_config, "sliding_window", None)
            and getattr(hf_config, "use_sliding_window", True)
            else -1
        ),
        window_pattern=_window_pattern_from_hf(hf_config),
    )


def llama_params_from_hf(model, dtype=jnp.bfloat16
                         ) -> Tuple[Params, LlamaConfig]:
    """Convert a `transformers.LlamaForCausalLM` (or compatible) instance.

    Norms stay fp32 (our convention); projections/embeddings cast to
    `dtype`. Handles tied word embeddings (lm_head absent -> reuse embed).
    """
    cfg = llama_config_from_hf(model.config, dtype=dtype)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def g(name):
        return sd[name]

    has_bias = "model.layers.0.self_attn.q_proj.bias" in sd
    if has_bias != cfg.qkv_bias:
        cfg = replace(cfg, qkv_bias=has_bias)
    # Qwen3-style per-head QK RMSNorm (normalized over head_dim pre-RoPE).
    has_qk_norm = "model.layers.0.self_attn.q_norm.weight" in sd
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        bias = {
            "bq": _a(g(p + "self_attn.q_proj.bias")),
            "bk": _a(g(p + "self_attn.k_proj.bias")),
            "bv": _a(g(p + "self_attn.v_proj.bias")),
        } if has_bias else {}
        if has_qk_norm:
            bias = dict(bias,
                        q_norm=_a(g(p + "self_attn.q_norm.weight")),
                        k_norm=_a(g(p + "self_attn.k_norm.weight")))
        layers.append({
            **bias,
            "attn_norm": _a(g(p + "input_layernorm.weight")),
            "wq": _t(g(p + "self_attn.q_proj.weight"), dtype),
            "wk": _t(g(p + "self_attn.k_proj.weight"), dtype),
            "wv": _t(g(p + "self_attn.v_proj.weight"), dtype),
            "wo": _t(g(p + "self_attn.o_proj.weight"), dtype),
            "mlp_norm": _a(g(p + "post_attention_layernorm.weight")),
            "w_gate": _t(g(p + "mlp.gate_proj.weight"), dtype),
            "w_up": _t(g(p + "mlp.up_proj.weight"), dtype),
            "w_down": _t(g(p + "mlp.down_proj.weight"), dtype),
        })
    embed = _a(g("model.embed_tokens.weight"), dtype)  # [vocab, dim], no T
    if "lm_head.weight" in sd:
        lm_head = _t(g("lm_head.weight"), dtype)
    else:  # tied embeddings
        lm_head = jnp.asarray(np.asarray(embed, np.float32).T).astype(dtype)
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": _a(g("model.norm.weight")),
        "lm_head": lm_head,
    }
    return params, cfg


def phi3_params_from_hf(model, dtype=jnp.bfloat16) -> Tuple[Params, LlamaConfig]:
    """Convert a `transformers.Phi3ForCausalLM`: Llama architecture with
    PACKED projections — `qkv_proj` is [q;k;v] stacked on the output dim and
    `gate_up_proj` is [gate;up] — so conversion just splits the matrices.
    Sliding window (when set) maps with the HF off-by-one (see
    `llama_config_from_hf`)."""
    hc = model.config
    sw = getattr(hc, "sliding_window", None)
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size,
        dim=hc.hidden_size,
        n_layers=hc.num_hidden_layers,
        n_heads=hc.num_attention_heads,
        n_kv_heads=getattr(hc, "num_key_value_heads", hc.num_attention_heads),
        hidden_dim=hc.intermediate_size,
        head_dim=hc.hidden_size // hc.num_attention_heads,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
        norm_eps=float(hc.rms_norm_eps),
        max_seq_len=hc.max_position_embeddings,
        dtype=dtype,
        sliding_window=int(sw) - 1 if sw else -1,
    )
    rs = getattr(hc, "rope_scaling", None)
    if rs is not None:
        raise NotImplementedError(
            f"phi3 rope_scaling {rs.get('type')!r} (longrope) not supported")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g = sd.__getitem__
    q_sz = cfg.n_heads * cfg.hd
    kv_sz = cfg.n_kv_heads * cfg.hd
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        qkv = _t(g(p + "self_attn.qkv_proj.weight"), dtype)   # [in, q+k+v]
        gate_up = _t(g(p + "mlp.gate_up_proj.weight"), dtype)  # [in, 2*hidden]
        layers.append({
            "attn_norm": _a(g(p + "input_layernorm.weight")),
            "wq": qkv[:, :q_sz],
            "wk": qkv[:, q_sz:q_sz + kv_sz],
            "wv": qkv[:, q_sz + kv_sz:],
            "wo": _t(g(p + "self_attn.o_proj.weight"), dtype),
            "mlp_norm": _a(g(p + "post_attention_layernorm.weight")),
            "w_gate": gate_up[:, :cfg.hidden_dim],
            "w_up": gate_up[:, cfg.hidden_dim:],
            "w_down": _t(g(p + "mlp.down_proj.weight"), dtype),
        })
    embed = _a(g("model.embed_tokens.weight"), dtype)
    if "lm_head.weight" in sd:
        lm_head = _t(g("lm_head.weight"), dtype)
    else:
        lm_head = jnp.asarray(np.asarray(embed, np.float32).T).astype(dtype)
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": _a(g("model.norm.weight")),
        "lm_head": lm_head,
    }
    return params, cfg


def _gemma_act(hc) -> str:
    """Map HF hidden_activation ('gelu_pytorch_tanh' vs exact 'gelu') to
    the model's activation modes; raise LOUDLY on anything else."""
    act = getattr(hc, "hidden_activation", None) or getattr(
        hc, "hidden_act", "gelu_pytorch_tanh")
    table = {"gelu_pytorch_tanh": "gelu_tanh", "gelu_new": "gelu_tanh",
             "gelu": "gelu"}
    if act not in table:
        raise NotImplementedError(f"unsupported gemma activation: {act!r}")
    return table[act]


def gemma_params_from_hf(model, dtype=jnp.bfloat16) -> Tuple[Params, LlamaConfig]:
    """Convert a `transformers.GemmaForCausalLM` to the LLaMA-family pytree.

    Gemma's three departures from Llama are ABSORBED at conversion so every
    forward path stays unchanged except the MLP activation:
    - RMSNorm computes x_norm * (1 + w)  ->  store w + 1;
    - activations are scaled sqrt(dim) at the embedding (but the TIED
      lm_head projects unscaled)  ->  scale params["embed"] only;
    - GeGLU MLP  ->  cfg.hidden_act = "gelu_tanh".
    head_dim is explicit (Gemma-2B uses 256 with dim 2048).
    """
    hc = model.config
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size,
        dim=hc.hidden_size,
        n_layers=hc.num_hidden_layers,
        n_heads=hc.num_attention_heads,
        n_kv_heads=hc.num_key_value_heads,
        hidden_dim=hc.intermediate_size,
        head_dim=hc.head_dim,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
        norm_eps=float(hc.rms_norm_eps),
        max_seq_len=hc.max_position_embeddings,
        dtype=dtype,
        hidden_act=_gemma_act(hc),
        logit_softcap=float(getattr(hc, "final_logit_softcapping", 0.0)
                            or 0.0),
    )
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g = sd.__getitem__

    def norm_plus1(name):
        return _a(g(name)) + 1.0

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers.append({
            "attn_norm": norm_plus1(p + "input_layernorm.weight"),
            "wq": _t(g(p + "self_attn.q_proj.weight"), dtype),
            "wk": _t(g(p + "self_attn.k_proj.weight"), dtype),
            "wv": _t(g(p + "self_attn.v_proj.weight"), dtype),
            "wo": _t(g(p + "self_attn.o_proj.weight"), dtype),
            "mlp_norm": norm_plus1(p + "post_attention_layernorm.weight"),
            "w_gate": _t(g(p + "mlp.gate_proj.weight"), dtype),
            "w_up": _t(g(p + "mlp.up_proj.weight"), dtype),
            "w_down": _t(g(p + "mlp.down_proj.weight"), dtype),
        })
    raw_embed = np.asarray(g("model.embed_tokens.weight"), np.float32)
    if "lm_head.weight" in sd:
        lm_head = _t(g("lm_head.weight"), dtype)
    else:  # tied: project with the UNSCALED embedding
        lm_head = jnp.asarray(raw_embed.T).astype(dtype)
    params = {
        "embed": jnp.asarray(
            raw_embed * np.sqrt(np.float32(cfg.dim))).astype(dtype),
        "layers": layers,
        "final_norm": norm_plus1("model.norm.weight"),
        "lm_head": lm_head,
    }
    return params, cfg


def gemma2_params_from_hf(model, dtype=jnp.bfloat16
                          ) -> Tuple[Params, LlamaConfig]:
    """Convert a `transformers.Gemma2ForCausalLM`. Beyond Gemma1's absorbed
    departures (see `gemma_params_from_hf`), Gemma2 adds — all mapped to
    first-class config/kernel features, not emulation:
    - POST-norms on both sublayer outputs -> "post_attn_norm"/"post_mlp_norm"
      layer keys (presence-driven in `models/llama.py`);
    - attention score softcapping -> `cfg.attn_softcap` (the flash kernels'
      native `softcap`, which the reference only has in its oracle);
    - sliding window on EVEN layers only -> `cfg.alt_window`;
    - softmax scale from query_pre_attn_scalar -> `cfg.attn_scale`;
    - final-logit softcapping -> `cfg.logit_softcap`.
    """
    hc = model.config
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size,
        dim=hc.hidden_size,
        n_layers=hc.num_hidden_layers,
        n_heads=hc.num_attention_heads,
        n_kv_heads=hc.num_key_value_heads,
        hidden_dim=hc.intermediate_size,
        head_dim=hc.head_dim,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
        norm_eps=float(hc.rms_norm_eps),
        max_seq_len=hc.max_position_embeddings,
        dtype=dtype,
        hidden_act=_gemma_act(hc),
        # HF counts the attending token inside the window; window_left
        # counts previous tokens only (verified vs HF eager at the boundary).
        sliding_window=int(hc.sliding_window) - 1,
        alt_window=True,
        attn_scale=float(hc.query_pre_attn_scalar) ** -0.5,
        attn_softcap=float(hc.attn_logit_softcapping or 0.0),
        logit_softcap=float(hc.final_logit_softcapping or 0.0),
    )
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g = sd.__getitem__

    def norm_plus1(name):
        return _a(g(name)) + 1.0

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers.append({
            "attn_norm": norm_plus1(p + "input_layernorm.weight"),
            # NB: HF Gemma2's "post_attention_layernorm" is a true POST-norm
            # on the attention OUTPUT (unlike Llama, where that name is the
            # pre-MLP norm); the pre-MLP norm is "pre_feedforward_layernorm".
            "post_attn_norm": norm_plus1(p + "post_attention_layernorm.weight"),
            "wq": _t(g(p + "self_attn.q_proj.weight"), dtype),
            "wk": _t(g(p + "self_attn.k_proj.weight"), dtype),
            "wv": _t(g(p + "self_attn.v_proj.weight"), dtype),
            "wo": _t(g(p + "self_attn.o_proj.weight"), dtype),
            "mlp_norm": norm_plus1(p + "pre_feedforward_layernorm.weight"),
            "post_mlp_norm": norm_plus1(p + "post_feedforward_layernorm.weight"),
            "w_gate": _t(g(p + "mlp.gate_proj.weight"), dtype),
            "w_up": _t(g(p + "mlp.up_proj.weight"), dtype),
            "w_down": _t(g(p + "mlp.down_proj.weight"), dtype),
        })
    raw_embed = np.asarray(g("model.embed_tokens.weight"), np.float32)
    if "lm_head.weight" in sd:
        lm_head = _t(g("lm_head.weight"), dtype)
    else:
        lm_head = jnp.asarray(raw_embed.T).astype(dtype)
    params = {
        "embed": jnp.asarray(
            raw_embed * np.sqrt(np.float32(cfg.dim))).astype(dtype),
        "layers": layers,
        "final_norm": norm_plus1("model.norm.weight"),
        "lm_head": lm_head,
    }
    return params, cfg


def gpt2_params_from_hf(model, dtype=jnp.float32):
    """Convert a `transformers.GPT2LMHeadModel` to `models/gpt2.py`'s pytree.

    HF GPT-2 uses Conv1D modules whose weights are ALREADY [in, out] — no
    transpose (unlike Linear-based Llama). Embeddings are tied in HF GPT-2;
    the pytree's tied form (`lm_head` absent) matches.
    """
    from fa2_jax.models.gpt2 import GPT2Config

    hc = model.config
    cfg = GPT2Config(
        vocab_size=hc.vocab_size, dim=hc.n_embd, n_layers=hc.n_layer,
        n_heads=hc.n_head, hidden_dim=4 * hc.n_embd,
        max_seq_len=hc.n_positions, norm_eps=float(hc.layer_norm_epsilon),
        dtype=dtype, tie_embeddings=True,
    )
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def g(name):
        return sd[name]

    layers = []
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        layers.append({
            "ln1_g": _a(g(p + "ln_1.weight")),
            "ln1_b": _a(g(p + "ln_1.bias")),
            "w_qkv": _a(g(p + "attn.c_attn.weight"), dtype),
            "b_qkv": _a(g(p + "attn.c_attn.bias")),
            "w_proj": _a(g(p + "attn.c_proj.weight"), dtype),
            "b_proj": _a(g(p + "attn.c_proj.bias")),
            "ln2_g": _a(g(p + "ln_2.weight")),
            "ln2_b": _a(g(p + "ln_2.bias")),
            "w_fc": _a(g(p + "mlp.c_fc.weight"), dtype),
            "b_fc": _a(g(p + "mlp.c_fc.bias")),
            "w_out": _a(g(p + "mlp.c_proj.weight"), dtype),
            "b_out": _a(g(p + "mlp.c_proj.bias")),
        })
    params = {
        "wte": _a(g("transformer.wte.weight"), dtype),
        "wpe": _a(g("transformer.wpe.weight"), dtype),
        "layers": layers,
        "lnf_g": _a(g("transformer.ln_f.weight")),
        "lnf_b": _a(g("transformer.ln_f.bias")),
    }
    return params, cfg
