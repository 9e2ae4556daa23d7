"""The MoE and scaled families on the llama graph (mixtral-style llama,
llama4, granitemoe, qwen3vlmoe, step35, laguna, gpt-oss, glm4moe, mellum,
hunyuan-moe, dots1, ernie4_5-moe, minimax-m2/m3, mimo2, cohere2_moe,
arctic, dbrx, grok, bailingmoe2, qwen2moe, qwen3moe), in the port against
the JAX package on the CPU: routers with biases and selection biases,
sigmoid gating, shared experts, dense FFNs beside the experts, sinks,
attention output gates, per-layer rope dims, NoPE layers with llama4's
temperature and chunked attention, SwiGLU limits. The rule of
test_torch_archs.py: the eager forwards over one token history, every
position's logits within 2% of the largest logit."""
import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu_torch.models import llama as TLM
from test_torch_archs import check_arch, rewrite

M2 = F.make_tiny_moe2_gguf
CASES = {
    "llama4": lambda p: F.make_tiny_llama4_gguf(p),
    "granitemoe": lambda p: M2(p, arch="granitemoe"),
    "qwen3vlmoe": lambda p: rewrite(F.make_tiny_moe_gguf(f"{p}.src"), p, arch="qwen3vlmoe"),
    "mixtral": lambda p: rewrite(M2(f"{p}.src", arch="llama"), p, arch="mixtral"),
    "step35": lambda p: F.make_tiny_step35_gguf(p),
    "laguna": lambda p: F.make_tiny_laguna_gguf(p),
    "gpt-oss": lambda p: F.make_tiny_gptoss_gguf(p),
    "glm4moe": lambda p: M2(p, arch="glm4moe"),
    "mellum": lambda p: M2(p, arch="mellum"),
    "hunyuan-moe": lambda p: M2(p, arch="hunyuan-moe"),
    "dots1": lambda p: M2(p, arch="dots1", n_head_kv=4, extra_kv={
        "dots1.expert_weights_scale": 1.5, "dots1.expert_gating_func": 2,
        "dots1.expert_weights_norm": True}),
    "ernie4_5-moe": lambda p: M2(p, arch="ernie4_5-moe"),
    "minimax-m2": lambda p: M2(p, arch="minimax-m2",
                               extra_kv={"minimax-m2.expert_gating_func": 2}),
    "minimax-m3": lambda p: M2(p, arch="minimax-m3", extra_kv={
        "minimax-m3.expert_gating_func": 2, "minimax-m3.expert_weights_norm": True}),
    "mimo2": lambda p: M2(p, arch="mimo2", extra_kv={
        "mimo2.attention.sliding_window": 16, "mimo2.rope.freq_base_swa": 10000.0,
        "mimo2.attention.sliding_window_pattern": [1, 0, 1]}),
    "cohere2_moe": lambda p: M2(p, arch="cohere2_moe", extra_kv={
        "cohere2_moe.attention.sliding_window": 16,
        "cohere2_moe.attention.sliding_window_pattern": [1, 1, 0],
        "cohere2_moe.logit_scale": 0.25, "cohere2_moe.leading_dense_block_count": 0}),
    "arctic": lambda p: M2(p, arch="arctic"),
    "dbrx": lambda p: M2(p, arch="dbrx"),
    "grok": lambda p: M2(p, arch="grok"),
    "bailingmoe2": lambda p: M2(p, arch="bailingmoe2"),
    "qwen2moe": lambda p: F.make_tiny_qwen2moe_gguf(p),
    "qwen3moe": lambda p: F.make_tiny_moe_gguf(p),
}


@pytest.mark.parametrize("arch", list(CASES))
def test_arch_matches_jax(tmp_path, arch):
    _, tr, _, _ = check_arch(CASES[arch](tmp_path / f"{arch}.gguf"))
    assert tr.cfg.arch == arch


def _step35_dense_first(path):
    """step35 whose first layer is a dense FFN with weights large enough
    that the layer's SwiGLU limit (swiglu_clamp_exp 7) clamps."""
    src = F.make_tiny_step35_gguf(f"{path}.src")
    rng = np.random.default_rng(4)
    e, ff = 64, 96
    big = {f"blk.0.{n}.weight": (rng.standard_normal(s) * 2.0).astype(np.float32)
           for n, s in (("ffn_gate", (ff, e)), ("ffn_up", (ff, e)), ("ffn_down", (e, ff)))}
    return rewrite(src, path, drop=("blk.0.ffn_gate_inp", "blk.0.ffn_gate_exps",
                                    "blk.0.ffn_up_exps", "blk.0.ffn_down_exps",
                                    "blk.0.ffn_gate_shexp", "blk.0.ffn_up_shexp",
                                    "blk.0.ffn_down_shexp"), extra=big)


def test_dense_ffn_takes_the_swiglu_limit(tmp_path, monkeypatch):
    """A dense FFN layer of a model with SwiGLU limits clamps as the JAX
    one does (the port dropped the limit on dense layers before); without
    the clamp the logits move far past the tolerance."""
    jr, tr, jl, _ = check_arch(_step35_dense_first(tmp_path / "s35.gguf"))
    assert "ffn_up" in tr.params["blocks"][0] and "experts" in tr.params["blocks"][1]
    monkeypatch.setattr(TLM, "_act_limit", lambda cfg, il, shared=False: 0.0)
    from test_torch_archs import forwards, N_PROMPT, STEPS
    ids = [int(x) for x in np.random.default_rng(0).integers(3, 250, N_PROMPT + STEPS)]
    _, unclamped = forwards(jr, tr, ids)
    assert np.abs(unclamped - jl).max() > 0.1 * np.abs(jl).max()
