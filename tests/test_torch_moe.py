"""The port's MoE routing and expert FFN, and the qwen3moe slice end to end,
against the JAX package on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from fixtures import make_tiny_moe_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

from test_torch_llama import _numpy_tree
from test_torch_moe_decode import experts_np, to_jax, to_torch

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernels: needs an NVIDIA GPU")

PROMPT = [int(x) for x in np.random.default_rng(11).integers(3, 250, 37)]


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    """qwen3moe with Q4_0 experts whose K (256) takes the supergroup path."""
    return make_tiny_moe_gguf(tmp_path_factory.mktemp("moe") / "moe.gguf",
                              n_embd=256, n_ff_exp=256, n_head=2, n_head_kv=1,
                              n_expert=8, n_expert_used=2, quant=GGMLType.Q4_0)


@pytest.fixture
def i8_on():
    JW.set_i8_mxu(True)
    TW.set_i8_mxu(True)
    yield
    JW.set_i8_mxu(None)
    TW.set_i8_mxu(None)


@pytest.mark.parametrize("gating,norm_topk,scale", [
    (JM.GATING_SOFTMAX, False, 1.0), (JM.GATING_SOFTMAX, True, 1.0),
    (JM.GATING_SIGMOID, True, 2.5), (JM.GATING_SOFTMAX_WEIGHT, False, 1.0)])
def test_route_matches_jax(gating, norm_topk, scale):
    """The same experts in the same order and weights to float32 rounding.
    Random logits have no ties; with ties torch.topk may order the tied
    experts differently from jax.lax.top_k."""
    rng = np.random.default_rng(gating)
    logits = rng.standard_normal((33, 16)).astype(np.float32)
    tw, ti = TM.route(torch.from_numpy(logits), 4, gating=gating, norm_topk=norm_topk,
                      scale=scale)
    jw, ji = JM.route(jnp.asarray(logits), 4, gating=gating, norm_topk=norm_topk,
                      scale=scale)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [1, 4, 64])
def test_moe_ffn_matches_jax(t):
    """T = 1 and 4 take the decode chain, 64 the sorted prefill (fused
    buckets and the ragged overflow pass here, the ragged chain in the JAX
    package on the CPU). Both quantize at the same points; the prefill
    requantizes h by 1/scale in the fused kernel where the ragged chain
    divides, which moves an int8 code by one step at times: 1% of the
    largest output."""
    rng = np.random.default_rng(t)
    d = experts_np(g=8, k=512, f=256, seed=t)
    x = rng.standard_normal((t, 512)).astype(np.float32)
    logits = rng.standard_normal((t, 8)).astype(np.float32)
    got = TM.moe_ffn(torch.from_numpy(x), torch.from_numpy(logits), to_torch(d), 2,
                     norm_topk=True).numpy()
    ref = np.asarray(JM.moe_ffn(jnp.asarray(x), jnp.asarray(logits), to_jax(d), 2,
                                norm_topk=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_moe_ffn_ragged_chain_matches_jax(monkeypatch):
    """With the fused kernel ruled out by shape the prefill runs the ragged
    chain, as the JAX package does on the CPU: the same numerics."""
    monkeypatch.setattr(TM, "fused_prefill_fits", lambda *a: False)
    rng = np.random.default_rng(5)
    d = experts_np(g=8, k=512, f=256, seed=5, bias=True)
    x = rng.standard_normal((40, 512)).astype(np.float32)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    got = TM.moe_ffn(torch.from_numpy(x), torch.from_numpy(logits), to_torch(d), 2,
                     activation="swiglu_oai").numpy()
    ref = np.asarray(JM.moe_ffn(jnp.asarray(x), jnp.asarray(logits), to_jax(d), 2,
                                activation="swiglu_oai"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("env", ["1", "0"])
def test_moe_fused_env_selects_the_chain(monkeypatch, env):
    """IK_MOE_FUSED=0 (read at call time, as the JAX package reads it)
    takes the ragged chain instead of the fused prefill; either way the
    output agrees with the JAX package's under the same variable."""
    monkeypatch.setenv("IK_MOE_FUSED", env)
    calls = []
    for name in ("fused_moe_prefill_i8", "_ragged_chain"):
        real = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _n=name, _f=real, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])
    rng = np.random.default_rng(9)
    d = experts_np(g=8, k=512, f=256, seed=9)
    x = rng.standard_normal((48, 512)).astype(np.float32)
    logits = rng.standard_normal((48, 8)).astype(np.float32)
    got = TM.moe_ffn(torch.from_numpy(x), torch.from_numpy(logits), to_torch(d), 2).numpy()
    ref = np.asarray(JM.moe_ffn(jnp.asarray(x), jnp.asarray(logits), to_jax(d), 2))
    assert calls == (["fused_moe_prefill_i8"] if env == "1" else ["_ragged_chain"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_greedy_tokens_match_jax_runtime(tiny_moe, i8_on):
    """The slice as a whole: the tiny qwen3moe GGUF through both runtimes
    with the int8 path on. 8 greedy steps give identical tokens; the
    prompt's logits agree to 3% of the largest (the rule of the dense
    slice's test, test_torch_llama.py: jit against eager rounding, and
    int8 steps that a one-ulp difference can cross)."""
    jr = JRuntime.from_gguf(tiny_moe, fuse=True)
    tr = TRuntime.from_gguf(tiny_moe, device="cpu", fuse=True)
    blk = tr.params["blocks"][0]
    assert isinstance(blk["experts"], TM.QuantExpertWeights) and blk["experts"].supergroup
    assert {"attn_q_norm", "attn_k_norm", "ffn_gate_inp", "wqkv"} <= blk.keys()
    _, jt = jr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    _, tt = tr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    assert tt == jt
    jl, _, _ = jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)
    tl, _, _ = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)
    jl, tl = np.asarray(jl), tl.numpy()
    tol = 3e-2 * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= tol
    # where the argmax differs the two best logits are within the tolerance
    picked = jl[np.arange(len(jl)), tl.argmax(-1)]
    assert (jl.max(-1) - picked <= 2 * tol).all()


def _tree(p):
    """_numpy_tree plus the JAX package's QuantExpertWeights and ExpertWeights."""
    if isinstance(p, (JM.QuantExpertWeights, JM.ExpertWeights)):
        d = {"type": type(p).__name__}
        for n in ("gate", "up", "down"):
            d[n] = np.asarray(getattr(p, n))
            if isinstance(p, JM.QuantExpertWeights):
                d[n + "_s"] = np.asarray(getattr(p, n + "_s"))
                d[n + "_group"] = getattr(p, n + "_group")
            b = getattr(p, n + "_b")
            d[n + "_b"] = None if b is None else np.asarray(b)
        return d
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_tree(v) for v in p]
    return _numpy_tree(p)


def _strides(t):
    """The strides that address something: those of dims longer than 1."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n > 1)


def _assert_same(a, b, where="params"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (TM.QuantExpertWeights, TM.ExpertWeights)):
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, nn.Module):
        assert getattr(a, "group", None) == getattr(b, "group", None), where
        _assert_same(dict(a.named_buffers()), dict(b.named_buffers()), where)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and _strides(a) == _strides(b), where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_params_from_numpy_reproduces_loaded_moe_params(tiny_moe, i8_on):
    """The JAX package's MoE parameters (router, QK-norms, supergroup
    experts) carried over as numpy equal the port's own load, layouts
    included."""
    jg, tg = j_load_gguf(tiny_moe), t_load_gguf(tiny_moe)
    jp = JLM.load_llama_params(jg, j_config(jg.metadata), fuse=True)
    tp = TLM.load_llama_params(tg, t_config(tg.metadata), "cpu", fuse=True)
    _assert_same(params_from_numpy(_tree(jp), "cpu"), tp)


def test_qwen3moe_config(tiny_moe):
    """The copied config reads a qwen3moe GGUF as the JAX package does:
    NEOX RoPE, QK-norms, normalized top-k weights, the expert FFN width."""
    meta = t_load_gguf(tiny_moe).metadata
    tc, jc = t_config(meta), j_config(meta)
    assert (tc.arch, tc.rope_type, tc.use_qk_norm, tc.norm_topk_prob) == ("qwen3moe", 2, True, True)
    assert (tc.n_expert, tc.n_expert_used, tc.n_ff_exp) == (8, 2, 256)
    for f in ("rope_type", "use_qk_norm", "norm_topk_prob", "n_ff_exp", "n_expert",
              "n_expert_used", "expert_gating_func", "expert_weights_scale", "moe_act"):
        assert getattr(tc, f) == getattr(jc, f), f


def test_planar_experts_load_and_run(tiny_moe):
    """int8 path off on the CPU: the experts stay planar (group 32, bf16
    scales) and the model runs the planar chain, tokens as the JAX runtime's."""
    tr = TRuntime.from_gguf(tiny_moe, device="cpu")
    ex = tr.params["blocks"][0]["experts"]
    assert isinstance(ex, TM.QuantExpertWeights) and not ex.supergroup
    assert (ex.gate_group, ex.down_group, ex.down_s.dtype) == (32, 32, torch.bfloat16)
    _, tt = tr.generate_greedy_on_device(PROMPT, 4, stop_at_eos=False)
    _, jt = JRuntime.from_gguf(tiny_moe).generate_greedy_on_device(PROMPT, 4, stop_at_eos=False)
    assert tt == jt


def test_float_experts_load_as_bf16_and_run(tmp_path, i8_on):
    """An F16 expert file has no planar form: bf16 ExpertWeights, int8 path
    on or not."""
    f16 = make_tiny_moe_gguf(tmp_path / "f16.gguf", n_layer=1, n_embd=256, n_ff_exp=256)
    tr = TRuntime.from_gguf(f16, device="cpu")
    assert isinstance(tr.params["blocks"][0]["experts"], TM.ExpertWeights)
    _, tt = tr.generate_greedy_on_device(PROMPT, 4, stop_at_eos=False)
    _, jt = JRuntime.from_gguf(f16).generate_greedy_on_device(PROMPT, 4, stop_at_eos=False)
    assert tt == jt


def test_fused_decode_env_runs(tiny_moe, i8_on, monkeypatch):
    """IK_MOE_FUSED_TG=1 takes the single-kernel decode (its plain version
    here) and gives the two-kernel chain's tokens."""
    tr = TRuntime.from_gguf(tiny_moe, device="cpu")
    _, base = tr.generate_greedy_on_device(PROMPT, 6, stop_at_eos=False)
    monkeypatch.setenv("IK_MOE_FUSED_TG", "1")
    seen = []
    real = TM.moe_decode_i8
    monkeypatch.setattr(TM, "moe_decode_i8",
                        lambda *a, **kw: (seen.append(kw["fused"]), real(*a, **kw))[1])
    _, got = tr.generate_greedy_on_device(PROMPT, 6, stop_at_eos=False)
    assert got == base and seen and all(seen)


def test_later_moe_slices_raise(tmp_path, monkeypatch):
    """What still waits: expert parallelism. A mixtral-style llama file (the
    tiny MoE file under the llama architecture), which earlier slices
    refused, now loads and runs the routed experts."""
    import fixtures
    from ik_llama_cpp_tpu.gguf.writer import GGUFWriter

    class LlamaArchWriter(GGUFWriter):      # the tiny MoE file under another architecture
        def __init__(self, path, arch):
            super().__init__(path, arch="llama")

        def add(self, key, val):
            super().add(key.replace("qwen3moe.", "llama."), val)

    path = tmp_path / "mixtral.gguf"
    monkeypatch.setattr(fixtures, "GGUFWriter", LlamaArchWriter)
    make_tiny_moe_gguf(path, n_layer=1)
    rt = TRuntime.from_gguf(path, device="cpu")
    assert rt.cfg.arch == "llama" and "experts" in rt.params["blocks"][0]
    assert len(rt.generate_greedy_on_device(PROMPT, 2, stop_at_eos=False)[1]) == 2
    d = experts_np(g=8, k=512, f=256)
    with pytest.raises(TypeError, match="ep_axis"):
        TM.moe_ffn(torch.zeros(2, 512), torch.zeros(2, 8), to_torch(d), 2, ep_axis="e")


# ------------------------------------------------------------------ card --
@needs_cuda
def test_tiny_moe_on_the_card_matches_cpu(tiny_moe, i8_on):
    """The kernel path on the card gives the CPU plain path's greedy tokens."""
    cpu = TRuntime.from_gguf(tiny_moe, device="cpu")
    gpu = TRuntime.from_gguf(tiny_moe, device="cuda")
    assert (gpu.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
            == cpu.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False))
