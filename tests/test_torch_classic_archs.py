"""The classic families on the llama graph (gpt2, gptneox, falcon, mpt,
bloom, starcoder, refact, phi2, stablelm, jais, olmo, baichuan, orion,
xverse, minicpm, qwen, codeshell, chatglm, glm4), in the port against the
JAX package on the CPU: LayerNorm models with their biases, fused and
biased q/k/v, learned positions, the embedding norm, parallel residuals,
ALiBi, clamped q/k/v, partial rope. The rule of test_torch_archs.py: the
eager forwards over one token history, every position's logits within 2%
of the largest logit."""
import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.ops.attention import alibi_slopes as j_alibi_slopes
from ik_llama_cpp_tpu_torch.ops.attention import alibi_slopes
from test_torch_archs import check_arch

C, L = F.make_tiny_classic_gguf, F.make_tiny_llamalike_gguf
CASES = {
    "gpt2": lambda p: C(p, arch="gpt2"),                 # learned positions
    "gptneox": lambda p: C(p, arch="gptneox",            # separate-norm parallel residual
                           extra_kv={"gptneox.use_parallel_residual": True}),
    "falcon": lambda p: C(p, arch="falcon", n_head_kv=2),
    "mpt": lambda p: C(p, arch="mpt", extra_kv={"mpt.attention.max_alibi_bias": 8.0,
                                                "mpt.attention.clamp_kqv": 2.0}),
    "bloom": lambda p: C(p, arch="bloom"),               # ALiBi, embedding LayerNorm
    "starcoder": lambda p: C(p, arch="starcoder"),
    "refact": lambda p: L(p, arch="refact"),
    "phi2": lambda p: C(p, arch="phi2", rope_dim=8),
    "stablelm": lambda p: C(p, arch="stablelm", n_head_kv=2,
                            overrides={"ffn_norm": False, "qk_norm": True}),
    "jais": lambda p: C(p, arch="jais", extra_kv={"jais.attention.max_alibi_bias": 8.0}),
    "olmo": lambda p: C(p, arch="olmo", extra_kv={"olmo.attention.clamp_kqv": 2.0,
                                                  "olmo.attention.layer_norm_epsilon": 1e-5}),
    "baichuan": lambda p: C(p, arch="baichuan"),
    "orion": lambda p: C(p, arch="orion"),
    "xverse": lambda p: C(p, arch="xverse"),
    "minicpm": lambda p: L(p, arch="minicpm", tied=True),
    "qwen": lambda p: C(p, arch="qwen"),
    "codeshell": lambda p: C(p, arch="codeshell", rope_dim=8),
    "chatglm": lambda p: C(p, arch="chatglm", n_head_kv=2, rope_dim=8),
    "glm4": lambda p: C(p, arch="glm4", rope_dim=8),
}


@pytest.mark.parametrize("arch", list(CASES))
def test_arch_matches_jax(tmp_path, arch):
    _, tr, _, _ = check_arch(CASES[arch](tmp_path / f"{arch}.gguf"))
    assert tr.cfg.arch == arch


@pytest.mark.parametrize("arch", ["stablelm", "gptneox"])
def test_sequential_forms_match_jax(tmp_path, arch):
    """stablelm with its ffn_norm and gptneox without the parallel residual:
    the sequential LayerNorm forms of the same files."""
    check_arch(C(tmp_path / f"{arch}.gguf", arch=arch, seed=3), seed=3)


@pytest.mark.parametrize("n_head,max_bias", [(8, 8.0), (12, 8.0), (4, 2.5)])
def test_alibi_slopes_match_jax(n_head, max_bias):
    """Bit for bit, a non-power-of-two head count included."""
    np.testing.assert_array_equal(alibi_slopes(n_head, max_bias),
                                  j_alibi_slopes(n_head, max_bias))
