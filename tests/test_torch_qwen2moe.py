"""The planar / mixed-format MoE slice as a whole: GGUF files through the
``Runtime`` of both packages on the CPU.

(a) the tiny qwen2moe fixture (F16: bf16 experts, a gated shared expert,
    q/k/v biases);
(b) a Q4_0 qwen2moe file sized so that, with the int8 path on, gate and up
    experts (K = 256) are re-coded per supergroup and down experts (K = 96)
    stay planar: the form a model whose expert width 256 does not divide
    takes by default on the card;
(c) the tiny qwen3moe fixture in Q4_0 at its default width (K = 64): every
    projection planar although the int8 path is on.

Each must give the same config, prefill logits within 3% of the largest
logit (the rule of the dense slice's test: jit against eager rounding, bf16
boundaries and int8 steps that a one-ulp difference can cross) and the same
greedy tokens; where a near-tie flips a pick, both runtimes are fed the JAX
tokens and every step's logits are held to the same 3%."""
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures import byte_vocab, make_tiny_moe_gguf, make_tiny_qwen2moe_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.quant.quantize import quantize
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

from test_torch_moe import _assert_same, _tree

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernels: needs an NVIDIA GPU")

PROMPT = [int(x) for x in np.random.default_rng(12).integers(3, 250, 37)]
STEPS = 8
CFG_FIELDS = ("arch", "n_layer", "n_embd", "n_head", "n_head_kv", "head_dim", "rope_type",
              "use_qk_norm", "norm_topk_prob", "n_expert", "n_expert_used", "n_ff_exp",
              "n_ff_shexp", "expert_gating_func", "expert_weights_scale", "moe_act",
              "moe_weight_before")


def make_q4_qwen2moe_gguf(path, *, n_layer=2, n_embd=256, n_head=4, n_head_kv=2, n_expert=6,
                          n_expert_used=2, n_ff_exp=96, n_ff_shexp=256, seed=0) -> Path:
    """qwen2moe with Q4_0 attention, experts and shared expert (F16
    embedding and head, f32 router, biases and norms)."""
    arch = "qwen2moe"
    rng = np.random.default_rng(seed)
    tokens, scores, types = byte_vocab()
    head_dim = n_embd // n_head
    w = GGUFWriter(Path(path), arch=arch)
    for key, val in (("block_count", n_layer), ("context_length", 512),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff_exp),
                     ("attention.head_count", n_head), ("attention.head_count_kv", n_head_kv),
                     ("attention.layer_norm_rms_epsilon", 1e-5), ("rope.freq_base", 10000.0),
                     ("rope.dimension_count", head_dim), ("expert_count", n_expert),
                     ("expert_used_count", n_expert_used),
                     ("expert_feed_forward_length", n_ff_exp),
                     ("expert_shared_feed_forward_length", n_ff_shexp),
                     ("vocab_size", len(tokens))):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)

    def randw(*shape, scale=None):
        return (rng.standard_normal(shape) * (scale or 1.0 / np.sqrt(shape[-1]))).astype(np.float32)

    def addw(name, arr, ttype=GGMLType.Q4_0):
        w.add_tensor(name, quantize(arr.reshape(-1, arr.shape[-1]), ttype),
                     shape=tuple(reversed(arr.shape)), ggml_type=ttype)

    addw("token_embd.weight", randw(len(tokens), n_embd, scale=0.5), GGMLType.F16)
    w.add_tensor("output_norm.weight", np.ones(n_embd, np.float32))
    addw("output.weight", randw(len(tokens), n_embd, scale=0.5), GGMLType.F16)
    kv_dim = n_head_kv * head_dim
    for i in range(n_layer):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", np.ones(n_embd, np.float32))
        w.add_tensor(p + "ffn_norm.weight", np.ones(n_embd, np.float32))
        addw(p + "attn_q.weight", randw(n_embd, n_embd))
        addw(p + "attn_k.weight", randw(kv_dim, n_embd))
        addw(p + "attn_v.weight", randw(kv_dim, n_embd))
        addw(p + "attn_output.weight", randw(n_embd, n_embd))
        w.add_tensor(p + "attn_q.bias", randw(n_embd) * 0.1)
        w.add_tensor(p + "attn_k.bias", randw(kv_dim) * 0.1)
        w.add_tensor(p + "attn_v.bias", randw(kv_dim) * 0.1)
        w.add_tensor(p + "ffn_gate_inp.weight", randw(n_expert, n_embd))
        addw(p + "ffn_gate_exps.weight", randw(n_expert, n_ff_exp, n_embd))
        addw(p + "ffn_up_exps.weight", randw(n_expert, n_ff_exp, n_embd))
        addw(p + "ffn_down_exps.weight", randw(n_expert, n_embd, n_ff_exp))
        addw(p + "ffn_gate_shexp.weight", randw(n_ff_shexp, n_embd))
        addw(p + "ffn_up_shexp.weight", randw(n_ff_shexp, n_embd))
        addw(p + "ffn_down_shexp.weight", randw(n_embd, n_ff_shexp))
        w.add_tensor(p + "ffn_gate_inp_shexp.weight", randw(1, n_embd))
    w.write()
    return Path(path)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen2moe")
    return {"f16": make_tiny_qwen2moe_gguf(d / "f16.gguf"),
            "mixed": make_q4_qwen2moe_gguf(d / "mixed.gguf"),
            "planar": make_tiny_moe_gguf(d / "planar.gguf", quant=GGMLType.Q4_0)}


@pytest.fixture
def i8_on():
    JW.set_i8_mxu(True)
    TW.set_i8_mxu(True)
    yield
    JW.set_i8_mxu(None)
    TW.set_i8_mxu(None)


def _stepwise(rt, toks, to_np):
    """Logits of the prompt's last position and of each of ``toks`` fed one
    by one after it: (len(toks) + 1, V)."""
    kv = rt.new_cache(1, 64)
    lg, kv, n = rt.eval_tokens(PROMPT, kv, 0)
    out = [to_np(lg)[-1]]
    for tok in toks:
        lg, kv, n = rt.eval_tokens([tok], kv, n)
        out.append(to_np(lg)[-1])
    return np.stack(out)


def _check_runtimes(path, expect):
    jr = JRuntime.from_gguf(path, fuse=True)
    tr = TRuntime.from_gguf(path, device="cpu", fuse=True)
    expect(tr.params["blocks"][0])
    for f in CFG_FIELDS:
        assert getattr(tr.cfg, f) == getattr(jr.cfg, f), f
    jl = np.asarray(jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)[0])
    tl = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)[0].numpy()
    tol = 3e-2 * np.abs(jl).max()
    assert np.isfinite(tl).all() and np.abs(tl - jl).max() <= tol
    _, jt = jr.generate_greedy_on_device(PROMPT, STEPS, stop_at_eos=False)
    _, tt = tr.generate_greedy_on_device(PROMPT, STEPS, stop_at_eos=False)
    assert len(tt) == STEPS
    if tt != jt:
        # a near-tie flipped a pick: one token history for both runtimes
        js = _stepwise(jr, jt, np.asarray)
        ts = _stepwise(tr, jt, lambda a: a.numpy())
        assert np.abs(ts - js).max() <= tol
        picked = js[np.arange(len(js)), ts.argmax(-1)]
        assert (js.max(-1) - picked <= 2 * tol).all()
    return tr


def test_qwen2moe_f16_matches_jax_runtime(ggufs):
    """(a): bf16 ExpertWeights, shared expert with its sigmoid gate, q/k/v
    biases (so q, k and v stay unfused)."""
    def expect(blk):
        assert isinstance(blk["experts"], TM.ExpertWeights)
        assert {"ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp", "ffn_gate_inp_shexp",
                "attn_q_bias", "attn_k_bias", "attn_v_bias", "wq", "wk", "wv"} <= blk.keys()
    tr = _check_runtimes(ggufs["f16"], expect)
    assert (tr.cfg.arch, tr.cfg.norm_topk_prob, tr.cfg.n_ff_shexp) == ("qwen2moe", False, 96)


def test_qwen2moe_mixed_q4_matches_jax_runtime(ggufs, i8_on):
    """(b): gate/up experts supergroup with f32 scales, down experts planar
    group 32 with bf16 scales; decode runs the planar chain, prefill the
    int8 grouped GEMM for gate and up and the planar one for down."""
    def expect(blk):
        ex = blk["experts"]
        assert isinstance(ex, TM.QuantExpertWeights) and not ex.supergroup
        assert (ex.gate_group, ex.up_group, ex.down_group) == (256, 256, 32)
        assert (ex.gate_s.dtype, ex.up_s.dtype, ex.down_s.dtype) == (
            torch.float32, torch.float32, torch.bfloat16)
        assert ex.gate.shape == (6, 256, 96) and ex.down.shape == (6, 96, 256)
        assert ex.down_s.shape == (6, 3, 256)
        assert all(type(blk[n]).__name__ == "QLinearI8"
                   for n in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp", "wq", "wo"))
    _check_runtimes(ggufs["mixed"], expect)


def test_qwen3moe_all_planar_matches_jax_runtime(ggufs, i8_on):
    """(c): K = 64 keeps every expert projection planar with the int8 path
    on (and every attention linear a planar QLinear)."""
    def expect(blk):
        ex = blk["experts"]
        assert isinstance(ex, TM.QuantExpertWeights)
        assert (ex.gate_group, ex.up_group, ex.down_group) == (32, 32, 32)
        assert {ex.gate_s.dtype, ex.up_s.dtype, ex.down_s.dtype} == {torch.bfloat16}
    _check_runtimes(ggufs["planar"], expect)


def test_use_quant_off_gives_bf16_experts(ggufs):
    """``use_quant=False`` dequantizes the experts to bf16 ExpertWeights, as
    the JAX loader does; both runtimes agree on the prompt's logits."""
    jr = JRuntime.from_gguf(ggufs["mixed"], use_quant=False)
    tr = TRuntime.from_gguf(ggufs["mixed"], device="cpu", use_quant=False)
    assert isinstance(tr.params["blocks"][0]["experts"], TM.ExpertWeights)
    jl = np.asarray(jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)[0])
    tl = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)[0].numpy()
    assert np.abs(tl - jl).max() <= 3e-2 * np.abs(jl).max()


@pytest.mark.parametrize("which", ["f16", "mixed", "planar"])
def test_params_from_numpy_reproduces_loaded_params(ggufs, i8_on, which):
    """The JAX package's parameter tree (bf16, mixed or planar experts, the
    shared expert's linears and gate, attention biases) carried over as
    numpy equals the port's own load, layouts and scale dtypes included."""
    jg, tg = j_load_gguf(ggufs[which]), t_load_gguf(ggufs[which])
    jp = JLM.load_llama_params(jg, j_config(jg.metadata), fuse=True)
    tp = TLM.load_llama_params(tg, t_config(tg.metadata), "cpu", fuse=True)
    _assert_same(params_from_numpy(_tree(jp), "cpu"), tp)


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("which", ["f16", "mixed", "planar"])
def test_on_the_card_matches_cpu(ggufs, i8_on, which):
    """The kernel path on the card against the CPU plain path over one
    token history: logits within 3% of the largest."""
    cpu = TRuntime.from_gguf(ggufs[which], device="cpu")
    gpu = TRuntime.from_gguf(ggufs[which], device="cuda")
    _, toks = cpu.generate_greedy_on_device(PROMPT, STEPS, stop_at_eos=False)
    a = _stepwise(cpu, toks, lambda t: t.numpy())
    b = _stepwise(gpu, toks, lambda t: t.cpu().numpy())
    assert np.abs(a - b).max() <= 3e-2 * np.abs(a).max()
