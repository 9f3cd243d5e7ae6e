"""HF checkpoint conversion (`models/convert.py`): logits parity against the
`transformers` eager forward on tiny random configs (MHA and GQA), and the
converted model running through this framework's KV-cache greedy decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from fa2_jax.models import forward
from fa2_jax.models.convert import llama_params_from_hf


def _tiny_hf(n_heads=4, n_kv=4, seed=0):
    torch.manual_seed(seed)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=n_heads,
        num_key_value_heads=n_kv, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    return model


@pytest.mark.parametrize("n_kv", [4, 2])
def test_logits_parity_vs_transformers(n_kv):
    model = _tiny_hf(n_kv=n_kv, seed=n_kv)
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    ids = np.random.RandomState(0).randint(0, 128, size=(2, 33))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=2e-4, rtol=2e-3)


def test_converted_model_greedy_decode_matches_hf():
    model = _tiny_hf(n_kv=2, seed=7)
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    prompt = [5, 9, 23, 40]
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours == hf_out, (ours, hf_out)


def test_tied_embeddings_supported():
    torch.manual_seed(1)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=True,
        attn_implementation="eager",
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    ids = np.random.RandomState(1).randint(0, 64, size=(1, 17))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=2e-4, rtol=2e-3)


def test_llama3_rope_scaling_parity_vs_transformers():
    """Llama-3.1-style rope_scaling (NTK-by-parts) must reproduce the HF
    forward; ignoring it would silently corrupt long-context checkpoints."""
    torch.manual_seed(23)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64},
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    assert cfg.rope_factors == (8.0, 1.0, 4.0, 64.0)
    # Sequence LONGER than the original context: the scaled frequencies are
    # actually load-bearing here, not just a pass-through.
    ids = np.random.RandomState(12).randint(0, 128, size=(2, 100))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)

    # Unsupported scaling types must raise, not silently mis-load.
    from dataclasses import replace as _rep  # noqa: F401
    bad = transformers.LlamaConfig(rope_scaling={"rope_type": "yarn",
                                                 "factor": 4.0})
    from fa2_jax.models.convert import _rope_factors_from_hf
    with pytest.raises(NotImplementedError):
        _rope_factors_from_hf(bad)


def test_qwen2_logits_parity_vs_transformers():
    """Qwen2 = Llama architecture + additive q/k/v biases; the converter
    detects the biases from the state dict and the model applies them
    (`models/llama.py:_qkv`)."""
    torch.manual_seed(11)
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    # HF zero-inits linear biases; randomize so the bias path is exercised.
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    assert cfg.qkv_bias and "bq" in params["layers"][0]
    assert any(float(np.abs(np.asarray(l["bq"])).max()) > 0
               for l in params["layers"])
    ids = np.random.RandomState(4).randint(0, 128, size=(2, 29))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)


def test_qwen2_greedy_decode_matches_hf():
    torch.manual_seed(13)
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    prompt = [3, 17, 88, 54]
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours == hf_out, (ours, hf_out)


def test_gemma_logits_parity_vs_transformers():
    """Gemma = Llama + (1+w) RMSNorm + sqrt(dim)-scaled embeddings + GeGLU +
    explicit head_dim + tied unscaled lm_head; the first three are absorbed
    at conversion (`models/convert.py:gemma_params_from_hf`)."""
    from fa2_jax.models.convert import gemma_params_from_hf

    torch.manual_seed(17)
    hf_cfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32,  # != hidden_size // num_heads: exercises explicit hd
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        attn_implementation="eager",
    )
    model = transformers.GemmaForCausalLM(hf_cfg).eval()
    params, cfg = gemma_params_from_hf(model, dtype=jnp.float32)
    assert cfg.hidden_act == "gelu_tanh" and cfg.hd == 32
    ids = np.random.RandomState(8).randint(0, 128, size=(2, 27))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)


def test_gemma_greedy_decode_matches_hf():
    from fa2_jax.models.convert import gemma_params_from_hf

    torch.manual_seed(19)
    hf_cfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        attn_implementation="eager",
    )
    model = transformers.GemmaForCausalLM(hf_cfg).eval()
    params, cfg = gemma_params_from_hf(model, dtype=jnp.float32)
    prompt = [9, 33, 71, 2]
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours == hf_out, (ours, hf_out)


def _tiny_gemma2(seed, sliding_window=32):
    torch.manual_seed(seed)
    hf_cfg = transformers.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True, attn_implementation="eager",
        sliding_window=sliding_window, query_pre_attn_scalar=24.0,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    )
    return transformers.Gemma2ForCausalLM(hf_cfg).eval()


def test_gemma2_logits_parity_vs_transformers():
    """Gemma2: post-norms, attention softcap (the kernels' native feature),
    query_pre_attn_scalar scale, ALTERNATING sliding windows, final-logit
    softcap — full-stack parity against the HF eager forward. The 60-token
    sequence exceeds the 32-token window, so the even layers' sliding
    masking is load-bearing."""
    from fa2_jax.models.convert import gemma2_params_from_hf

    model = _tiny_gemma2(29)
    params, cfg = gemma2_params_from_hf(model, dtype=jnp.float32)
    assert cfg.alt_window and cfg.attn_softcap == 50.0
    assert cfg.window_for(0) == 31 and cfg.window_for(1) == -1
    assert "post_attn_norm" in params["layers"][0]
    ids = np.random.RandomState(14).randint(0, 128, size=(2, 60))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)


def test_gemma2_greedy_decode_matches_hf():
    """The CACHED decode path (forward_with_cache with per-layer windows +
    softcap through `flash_attn_with_kv_cache`) against HF generate."""
    from fa2_jax.models.convert import gemma2_params_from_hf

    model = _tiny_gemma2(31)
    params, cfg = gemma2_params_from_hf(model, dtype=jnp.float32)
    prompt = np.random.RandomState(15).randint(0, 128, size=40).tolist()
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours == hf_out, (ours, hf_out)


def test_logit_softcap_applied():
    """cfg.logit_softcap caps every forward path's logits (Gemma2-style)."""
    from fa2_jax.models import LlamaConfig as LC, init_params
    from dataclasses import replace as rep

    cfg = LC(vocab_size=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
             hidden_dim=48, max_seq_len=64, dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(2), cfg)
    ids = jnp.asarray([[1, 5, 9]], jnp.int32)
    raw = forward(params, ids, cfg)
    cap = 0.5 * float(jnp.max(jnp.abs(raw)))
    capped = forward(params, ids, rep(cfg, logit_softcap=cap))
    assert float(jnp.max(jnp.abs(capped))) <= cap + 1e-6
    np.testing.assert_allclose(
        np.asarray(capped), cap * np.tanh(np.asarray(raw) / cap), rtol=1e-6)


def test_gpt2_logits_parity_vs_transformers():
    from fa2_jax.models import gpt2
    from fa2_jax.models.convert import gpt2_params_from_hf

    torch.manual_seed(3)
    hf_cfg = transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        attn_implementation="eager",
    )
    model = transformers.GPT2LMHeadModel(hf_cfg).eval()
    params, cfg = gpt2_params_from_hf(model, dtype=jnp.float32)
    ids = np.random.RandomState(2).randint(0, 128, size=(2, 21))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(gpt2.forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)


@pytest.mark.parametrize("paged", [False, True])
def test_gemma2_served_through_engine(paged):
    """Gemma2 through the serving Engine: the DECODE KERNELS' softcap +
    per-layer alternating windows (`ops/decode.py`) must reproduce HF
    generate token-for-token."""
    from fa2_jax.models.convert import gemma2_params_from_hf
    from fa2_jax.runtime import Engine

    model = _tiny_gemma2(37)
    params, cfg = gemma2_params_from_hf(model, dtype=jnp.float32)
    prompt = np.random.RandomState(16).randint(0, 128, size=40).tolist()
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    eng = Engine(params, cfg, n_slots=2, max_seq=128, paged=paged)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert req.out_tokens == hf_out, (paged, req.out_tokens, hf_out)


def test_qwen3_logits_and_decode_parity_vs_transformers():
    """Qwen3 = Llama + per-head QK RMSNorm pre-RoPE (no qkv biases); the
    converter detects q_norm/k_norm from the state dict."""
    torch.manual_seed(41)
    hf_cfg = transformers.Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=128, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    model = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    assert "q_norm" in params["layers"][0] and not cfg.qkv_bias
    ids = np.random.RandomState(18).randint(0, 128, size=(2, 31))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)

    prompt = [8, 44, 91, 3]
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours_dec = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours_dec == hf_out, (ours_dec, hf_out)


def test_phi3_logits_and_decode_parity_vs_transformers():
    """Phi-3 = Llama with PACKED qkv_proj / gate_up_proj; conversion splits
    the stacked matrices."""
    from fa2_jax.models.convert import phi3_params_from_hf

    torch.manual_seed(43)
    hf_cfg = transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        sliding_window=None, pad_token_id=0, bos_token_id=1, eos_token_id=2,
    )
    model = transformers.Phi3ForCausalLM(hf_cfg).eval()
    params, cfg = phi3_params_from_hf(model, dtype=jnp.float32)
    ids = np.random.RandomState(20).randint(0, 128, size=(2, 35))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)

    prompt = [2, 77, 13, 50]
    n_new = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
            num_beams=1, pad_token_id=0,
        )[0, len(prompt):].tolist()
    from fa2_jax.runtime.speculative import greedy_reference

    ours_dec = greedy_reference(params, cfg, prompt, n_new, max_seq=128)
    assert ours_dec == hf_out, (ours_dec, hf_out)


def test_qwen2_max_window_layers_gating():
    """Qwen2 with use_sliding_window=True applies FULL attention to the
    first max_window_layers layers (HF layer_types); the converter maps this
    to LlamaConfig.window_pattern and logits match HF past the window."""
    torch.manual_seed(47)
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        use_sliding_window=True, sliding_window=32, max_window_layers=2,
    )
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    params, cfg = llama_params_from_hf(model, dtype=jnp.float32)
    assert cfg.window_pattern == (False, False, True, True)
    assert cfg.window_for(0) == -1 and cfg.window_for(2) == 31
    ids = np.random.RandomState(22).randint(0, 128, size=(2, 70))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits.numpy()
    ours = np.asarray(forward(params, jnp.asarray(ids, jnp.int32), cfg))
    np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=2e-3)
