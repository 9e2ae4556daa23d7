"""The port's dense llama end to end against the JAX package on the CPU:
the same tiny GGUF through both runtimes, with the int8 weight path on and
off and the q/k/v and gate/up fusion on and off."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernels: needs an NVIDIA GPU")

PROMPT = [int(x) for x in np.random.default_rng(11).integers(3, 270, 37)]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("tiny") / "tiny.gguf",
                                seed=5, n_embd=256, n_head=2, n_head_kv=1,
                                n_ff=512, quant=GGMLType.Q4_0)


@pytest.fixture
def i8_path(request):
    flag = request.param
    JW.set_i8_mxu(flag)
    TW.set_i8_mxu(flag)
    yield flag
    JW.set_i8_mxu(None)
    TW.set_i8_mxu(None)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("i8_path", [True, False], indirect=True)
def test_greedy_tokens_match_jax_runtime(tiny, i8_path, fuse):
    """8 greedy steps give identical tokens. The prompt's logits agree to
    3% of the largest logit: XLA's fused jit rounds the bf16 residual
    stream at other points than eager execution (the JAX package against
    itself, jit against eager, differs by about 1% here), and with the int8
    path a one-ulp difference can move an activation across an int8
    rounding step."""
    jr = JRuntime.from_gguf(tiny, fuse=fuse)
    tr = TRuntime.from_gguf(tiny, device="cpu", fuse=fuse)
    kinds = {type(v).__name__ for v in tr.params["blocks"][0].values()
             if isinstance(v, nn.Module)}
    assert kinds == {"QLinearI8" if i8_path else "QLinear"}
    _, jt = jr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    _, tt = tr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    assert tt == jt
    jl, _, jn = jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)
    tl, kv, tn = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)
    assert tn == jn == len(PROMPT) and kv.capacity == 256
    assert np.abs(tl.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()
    assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()


@pytest.mark.parametrize("i8_path", [True, False], indirect=True)
def test_forward_matches_jax_eager(tiny, i8_path):
    """One un-jitted JAX forward against the port's on the same tokens: the
    same operations in the same order round alike, up to float32 sums
    taken in another order."""
    jg, tg = j_load_gguf(tiny), t_load_gguf(tiny)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    jp = JLM.load_llama_params(jg, jc, fuse=True)
    tp = TLM.load_llama_params(tg, tc, "cpu", fuse=True)
    toks = np.asarray(PROMPT[:16], np.int32)[None]
    jlog, _ = JLM.forward(jp, jc, jnp.asarray(toks), JLM.KVCache.create(jc, 1, 256),
                          jnp.int32(0))
    tlog = TLM.forward(tp, tc, torch.from_numpy(toks), TLM.KVCache.create(tc, 1, 256, "cpu"), 0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(jlog)).max()))


def _numpy_tree(p):
    """The JAX parameter pytree with every array fetched to numpy and each
    linear as a tagged dict (params_from_numpy's input format)."""
    if isinstance(p, JW.QLinearI8):
        return {"type": "QLinearI8", "codes": np.asarray(p.codes),
                "sw": np.asarray(p.sw), "group": p.group,
                "gbias": None if p.gbias is None else np.asarray(p.gbias)}
    if isinstance(p, JW.QLinear):
        return {"type": "QLinear", "codes": np.asarray(p.codes),
                "scale": np.asarray(p.scale), "group": p.group,
                "bias": None if p.bias is None else np.asarray(p.bias)}
    if isinstance(p, JW.DenseLinear):
        return {"type": "DenseLinear", "w": np.asarray(p.w)}
    if isinstance(p, dict):
        return {k: _numpy_tree(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_numpy_tree(v) for v in p]
    return np.asarray(p)


def _assert_same(a, b, where="params"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, nn.Module):
        assert getattr(a, "group", None) == getattr(b, "group", None), where
        ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
        assert ba.keys() == bb.keys(), where
        for k in ba:
            _assert_same(ba[k], bb[k], f"{where}.{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where


@pytest.mark.parametrize("i8_path", [True, False], indirect=True)
def test_params_from_numpy_reproduces_loaded_params(tiny, i8_path):
    jg, tg = j_load_gguf(tiny), t_load_gguf(tiny)
    jp = JLM.load_llama_params(jg, j_config(jg.metadata), fuse=True)
    tp = TLM.load_llama_params(tg, t_config(tg.metadata), "cpu", fuse=True)
    _assert_same(params_from_numpy(_numpy_tree(jp), "cpu"), tp)


def test_kv_cache_rows_land_in_place(tiny):
    """Decode writes its rows into the stacked cache without copying it."""
    tr = TRuntime.from_gguf(tiny, device="cpu")
    kv = tr.new_cache(1, 40)
    ptr = kv.k.data_ptr()
    _, kv, n = tr.eval_tokens(PROMPT[:10], kv, 0)
    assert kv.k.data_ptr() == ptr and n == 10
    assert kv.k[:, 0, :10].abs().sum() > 0 and kv.k[:, 0, 16:].abs().sum() == 0


def test_later_slices_raise(tiny, tmp_path):
    """What still waits raises and names its queue item: multi-GPU serving,
    the architectures with a forward of their own, the JAX forward's extra
    inputs. What this slice ported loads: --swa-compress on a model with no
    sliding window gives the plain cache (as the JAX runtime does), and a
    gemma file (another architecture of the llama graph) runs."""
    tr = TRuntime.from_gguf(tiny, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TRuntime.from_gguf(tiny, device="cpu", tensor_parallel=2)
    ids, out = tr.generate("hello", 2)       # text prompts: the tokenizer slice
    assert ids == tr.tokenizer.encode("hello") and len(out) == 2
    ring = TRuntime.from_gguf(tiny, device="cpu", swa_compress=True)
    assert type(ring.new_cache(1, 2048)) is TLM.KVCache
    gemma = make_tiny_llama_gguf(tmp_path / "g.gguf", arch="gemma", n_layer=1)
    assert len(TRuntime.from_gguf(gemma, device="cpu").generate([5, 6, 7], 2)[1]) == 2
    from fixtures import make_tiny_t5_gguf
    with pytest.raises(NotImplementedError, match=r"item 8"):
        TRuntime.from_gguf(make_tiny_t5_gguf(tmp_path / "t5.gguf"), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 9"):
        TLM.forward(tr.params, tr.cfg, torch.zeros((1, 8), dtype=torch.int64),
                    tr.new_cache(1, 16), 0, collect_stats=True)


@needs_cuda
def test_tiny_model_on_the_card_matches_cpu(tiny):
    """The kernel path on the card gives the CPU plain path's greedy tokens."""
    TW.set_i8_mxu(True)
    try:
        cpu = TRuntime.from_gguf(tiny, device="cpu")
        gpu = TRuntime.from_gguf(tiny, device="cuda")
    finally:
        TW.set_i8_mxu(None)
    assert (gpu.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
            == cpu.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False))
