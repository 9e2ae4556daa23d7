"""The quantized-KV and packed-int4 slice of the port as a whole, against
the JAX package on the CPU: the same tiny GGUF through both runtimes for
each KV codec, with and without the Hadamard rotation, with the per-layer
codec dict, and with 4-bit packed weights.

On the CPU both packages take their plain attention paths, which differ in
one rounding: the JAX model rounds the dequantized K to bf16 before
``attend``, the port's plain version keeps code * scale in float32 as the
kernels do. Cache codes written by later layers may therefore differ by a
step where a bf16 K differs, so whole-model runs compare greedy tokens and
logits; bits are compared at the op level (test_torch_kv_quant.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.convert import kv_from_numpy
from ik_llama_cpp_tpu_torch.ops import kv_quant as TQ
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernels: needs an NVIDIA GPU")

PROMPT = [int(x) for x in np.random.default_rng(11).integers(3, 270, 37)]
# share of the largest logit: 3% as for the bf16 cache (test_torch_llama.py);
# a 4-bit code step is 1/7 (q4) or up to 24/127 (nl4) of its row's largest
# value, so a code that flips with the bf16 rounding of K moves more
LOGIT_TOL = {"q8": 0.03, "q6": 0.03, "q4": 0.06, "nl4": 0.06}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("kvq") / "tiny.gguf",
                                seed=5, n_embd=256, n_head=2, n_head_kv=1,
                                n_ff=512, quant=GGMLType.Q4_0)


@pytest.fixture(scope="module")
def tiny4(tmp_path_factory):
    """Four layers, so that first/last overrides leave a bulk."""
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("kvq4") / "tiny4.gguf",
                                seed=6, n_layer=4, n_embd=256, n_head=2,
                                n_head_kv=1, n_ff=512, quant=GGMLType.Q4_0)


def both(path, tol, **kw):
    """Greedy tokens identical over 8 steps; the prompt's logits within
    ``tol`` of the largest logit, the same argmax at 90% of the positions."""
    jr = JRuntime.from_gguf(path, **kw)
    tr = TRuntime.from_gguf(path, device="cpu", **kw)
    _, jt = jr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    _, tt = tr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    assert tt == jt
    jl, jkv, jn = jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)
    tl, tkv, tn = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)
    assert tn == jn == len(PROMPT) and tkv.capacity == jkv.capacity == 256
    assert np.isfinite(tl.numpy()).all()
    assert np.abs(tl.numpy() - jl).max() <= tol * np.abs(jl).max()
    assert (tl.numpy().argmax(-1) == jl.argmax(-1)).mean() >= 0.9
    return jr, tr, jkv, tkv


@pytest.mark.parametrize("hadamard", [False, True], ids=["plain", "khad_vhad"])
@pytest.mark.parametrize("codec", ["q8", "q4", "q6", "nl4"])
def test_quantized_cache_matches_jax_runtime(tiny, codec, hadamard):
    jr, tr, jkv, tkv = both(tiny, LOGIT_TOL[codec], kv_quant=codec,
                            k_hadamard=hadamard, v_hadamard=hadamard)
    assert tr.cfg.k_hadamard is hadamard and tr.cfg.v_hadamard is hadamard
    assert tkv.quantized and TQ.kv_codec_of(tkv.k, tr.cfg.head_dim) == codec
    assert tuple(tkv.k.shape) == tuple(jkv.k.shape)
    assert str(tkv.k.dtype).split(".")[1] == str(jkv.k.dtype)
    n = len(PROMPT)
    # layer 0 sees identical inputs up to float32 summation order: its codes
    # agree but for a stray rounding step, its scales to 1e-4; rows past the
    # bucket-padded write stay zero
    differ = (tkv.k[0, :, :n].numpy() != np.asarray(jkv.k[0, :, :n])).mean()
    assert differ <= 0.02, f"{differ:.2%} of layer 0's K bytes differ"
    np.testing.assert_allclose(tkv.k_scale[0, :, :n].numpy(),
                               np.asarray(jkv.k_scale[0, :, :n]), rtol=1e-3)
    assert int(tkv.k[:, :, 64:].to(torch.int32).abs().sum()) == 0


def test_mixed_cache_dict_matches_jax_runtime(tiny4):
    spec = {"type": "q4", "first": "q8", "n_first": 1, "last": "q8", "n_last": 1}
    jr, tr, jkv, tkv = both(tiny4, LOGIT_TOL["q4"], kv_quant=spec)
    assert isinstance(tkv, TLM.MixedKVCache) and tkv.layer_map == jkv.layer_map == (0, -1, -2, 1)
    d = tr.cfg.head_dim
    assert [TQ.kv_codec_of(tkv.k[i], d) for i in range(4)] == ["q8", "q4", "q4", "q8"]
    assert tkv.k_mid.shape == (2, 1, 256, 1, d // 2) and tkv.k_ovr.shape == (2, 1, 256, 1, d)


def test_mixed_cache_dict_forms(tiny):
    """n_first / n_last default to 1 only where 'first' / 'last' is given; a
    dict that overrides every layer gives a plain cache of the override."""
    tr = TRuntime.from_gguf(tiny, device="cpu", kv_quant={"type": "q4", "first": "q6"})
    kv = tr.new_cache(1, 32)                     # 2 layers: first = q6, the other q4
    assert isinstance(kv, TLM.MixedKVCache) and kv.layer_map == (0, -1)
    assert TQ.kv_codec_of(kv.k[0], 128) == "q6" and TQ.kv_codec_of(kv.k[1], 128) == "q4"
    tr.kv_quant = {"type": "q4", "first": "q8", "last": "q8"}
    kv = tr.new_cache(1, 32)
    assert isinstance(kv, TLM.KVCache) and TQ.kv_codec_of(kv.k, 128) == "q8"
    jr = JRuntime.from_gguf(tiny, kv_quant={"type": "q4", "first": "q8", "last": "q8"})
    assert jr.new_cache(1, 32).k.dtype == jnp.int8


@pytest.mark.parametrize("quant,codec", [(True, "q8"), ("q8", "q8"), ("q4", "q4"),
                                         ("q6", "q6"), ("nl4", "nl4"), ("iq4_nl", "nl4")])
def test_cache_types(tiny, quant, codec):
    tr = TRuntime.from_gguf(tiny, device="cpu", kv_quant=quant)
    jr = JRuntime.from_gguf(tiny, kv_quant=quant)
    kv, jkv = tr.new_cache(1, 100), jr.new_cache(1, 100)
    assert kv.quantized and kv.capacity == jkv.capacity == 256
    assert TQ.kv_codec_of(kv.k, tr.cfg.head_dim) == codec
    assert tuple(kv.k.shape) == tuple(jkv.k.shape) and tuple(kv.k_scale.shape) == tuple(jkv.k_scale.shape)
    assert kv.k_scale.dtype == torch.float32 and kv.v.dtype == kv.k.dtype
    with pytest.raises(ValueError, match="unknown KV cache type"):
        TLM.KVCache.create(tr.cfg, 1, 64, "cpu", quant="q5")


def test_hadamard_on_a_bf16_cache_is_exact_math(tiny):
    """With an unquantized cache the rotation is pure math: the logits of
    the rotated and the un-rotated run agree to the bf16 rounding of the
    rotated K, V and q (1% of the largest logit), with the same argmax."""
    t0 = TRuntime.from_gguf(tiny, device="cpu")
    t1 = TRuntime.from_gguf(tiny, device="cpu", k_hadamard=True, v_hadamard=True)
    assert t1.cfg.k_hadamard and t1.cfg.v_hadamard and not t0.cfg.k_hadamard
    l0, _, _ = t0.eval_tokens(PROMPT, t0.new_cache(1, 64), 0, all_logits=True)
    l1, kv, _ = t1.eval_tokens(PROMPT, t1.new_cache(1, 64), 0, all_logits=True)
    assert not kv.quantized and kv.k.dtype == torch.bfloat16
    assert float((l0 - l1).abs().max()) <= 1e-2 * float(l0.abs().max())
    assert bool((l0.argmax(-1) == l1.argmax(-1)).all())
    both(tiny, 0.03, k_hadamard=True, v_hadamard=True)        # and against JAX


def test_packed_int4_weights_match_jax_runtime(tiny):
    JW.set_pack_int4(True)
    TW.set_pack_int4(True)
    try:
        jr, tr, _, _ = both(tiny, 0.03)
        _, tr8, _, _ = both(tiny, LOGIT_TOL["q8"], kv_quant="q8")
    finally:
        JW.set_pack_int4(False)
        TW.set_pack_int4(False)
    for rt in (tr, tr8):
        kinds = {type(v).__name__ for v in rt.params["blocks"][0].values()
                 if isinstance(v, torch.nn.Module)}
        assert kinds == {"QLinearI4"}
    assert isinstance(jr.params["blocks"][0]["wo"], JW.QLinearI4)


@pytest.mark.parametrize("quant", [False, "q8", "q6"])
def test_prefill_in_jax_decode_in_the_port(tiny, quant):
    """``kv_from_numpy`` carries a JAX cache over: the port continues from
    the JAX prefill with the tokens the JAX runtime decodes."""
    jr = JRuntime.from_gguf(tiny, kv_quant=quant)
    tr = TRuntime.from_gguf(tiny, device="cpu", kv_quant=quant)
    _, jt = jr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    jl, jkv, n = jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0)
    arrs = [None if a is None else np.asarray(a)
            for a in (jkv.k, jkv.v, jkv.k_scale, jkv.v_scale)]
    kv = kv_from_numpy(*arrs, device="cpu")
    assert kv.quantized is bool(quant) and kv.capacity == 256
    assert kv.k.dtype == tr.new_cache(1, 64).k.dtype
    first = int(np.asarray(jl)[-1].argmax())
    toks = tr._decode_loop(torch.tensor([[first]]), kv, n, 7)
    assert [first] + toks[0].tolist() == jt


def test_later_slices_still_raise(tiny):
    """Multi-GPU serving still waits; --swa-compress over a quantized cache
    gives the plain quantized cache, as the JAX runtime does (its rings are
    bf16 only)."""
    rt = TRuntime.from_gguf(tiny, device="cpu", kv_quant="q8", swa_compress=True)
    kv = rt.new_cache(1, 2048)
    assert type(kv) is TLM.KVCache and kv.quantized
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TRuntime.from_gguf(tiny, device="cpu", kv_quant="q8", tensor_parallel=2)


@needs_cuda
@pytest.mark.parametrize("quant", ["q8", "q4", "q6", "nl4",
                                   {"type": "q4", "first": "q8"}])
def test_tiny_model_on_the_card_matches_cpu(tiny, quant):
    """The kernel path on the card against the CPU plain path over one token
    history (the CPU run's greedy tokens, fed one by one so that the decode
    kernel runs): every step's logits within the codec's share of the
    largest logit, and the same pick wherever the CPU's top-2 gap exceeds
    twice that step's error. Free-running greedy tokens are no robust
    comparison: a near-tie flips with the bf16 rounding of the kernels'
    probabilities."""
    TW.set_i8_mxu(True)
    try:
        cpu = TRuntime.from_gguf(tiny, device="cpu", kv_quant=quant)
        gpu = TRuntime.from_gguf(tiny, device="cuda", kv_quant=quant)
    finally:
        TW.set_i8_mxu(None)
    _, toks = cpu.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)

    def forced(rt):
        lg, kv, n = rt.eval_tokens(PROMPT, rt.new_cache(1, 64), 0)
        outs = [lg[-1]]
        for tok in toks:
            lg, kv, n = rt.eval_tokens([tok], kv, n)
            outs.append(lg[-1])
        return torch.stack(outs).cpu()

    lc, lg = forced(cpu), forced(gpu)
    err = (lc - lg).abs().amax(dim=1)
    tol = LOGIT_TOL["q4" if isinstance(quant, dict) else quant]
    assert float(err.max()) <= tol * float(lc.abs().max())
    top2 = lc.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    assert bool((lc.argmax(1) == lg.argmax(1))[clear].all())
