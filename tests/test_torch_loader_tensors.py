"""Tensors a llama GGUF may carry beyond the plain graph: FFN biases, an
lm-head bias and the sandwich norms, applied in the port as in the JAX
package (CPU, against its un-jitted forward); a block tensor that neither
applies is refused at load, never dropped."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_llamalike_gguf
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

N_LAYER, N_EMBD, N_FF = 2, 64, 128
PROMPT = np.asarray(np.random.default_rng(5).integers(3, 250, 24), np.int32)[None]


def _rewrite(src, dst, extra: dict):
    """src's metadata and tensors, plus ``extra`` (name -> float32 array),
    written to dst."""
    m = t_load_gguf(src)
    w = GGUFWriter(dst)
    for key, val in m.metadata.items():
        w.add(key, val)
    for name, info in m.tensors.items():
        w.add_tensor(name, info.data, shape=info.shape, ggml_type=info.ggml_type)
    for name, arr in extra.items():
        w.add_tensor(name, arr)
    w.write()
    return dst


def _extras(n_vocab: int, which, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(N_LAYER):
        p = f"blk.{i}."
        full = {p + "ffn_gate.bias": N_FF, p + "ffn_up.bias": N_FF,
                p + "ffn_down.bias": N_EMBD, p + "post_attention_norm.weight": N_EMBD,
                p + "post_ffw_norm.weight": N_EMBD}
        for name, width in full.items():
            if any(w in name for w in which):
                base = 1.0 if name.endswith("norm.weight") else 0.0
                out[name] = (base + 0.3 * rng.standard_normal(width)).astype(np.float32)
    if "output.bias" in which:
        out["output.bias"] = (3.0 * rng.standard_normal(n_vocab)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_tiny_llamalike_gguf(tmp_path_factory.mktemp("ld") / "base.gguf", arch="llama",
                                    seed=3, n_layer=N_LAYER, n_embd=N_EMBD, n_ff=N_FF)


def _logits(path, fuse: bool):
    jg, tg = j_load_gguf(path), t_load_gguf(path)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    jp = JLM.load_llama_params(jg, jc, fuse=fuse)
    tp = TLM.load_llama_params(tg, tc, "cpu", fuse=fuse)
    jl, _ = JLM.forward(jp, jc, jnp.asarray(PROMPT), JLM.KVCache.create(jc, 1, 64), jnp.int32(0))
    tl = TLM.forward(tp, tc, torch.from_numpy(PROMPT), TLM.KVCache.create(tc, 1, 64, "cpu"), 0)
    return np.asarray(jl), tl.numpy(), tp


WHICH = {"ffn biases": ("ffn_gate.bias", "ffn_up.bias", "ffn_down.bias"),
         "output bias": ("output.bias",),
         "sandwich norms": ("post_attention_norm", "post_ffw_norm"),
         "all": ("ffn_gate.bias", "ffn_up.bias", "ffn_down.bias", "output.bias",
                 "post_attention_norm", "post_ffw_norm")}


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("which", list(WHICH))
def test_extra_tensors_match_jax(base, tmp_path, which, fuse):
    """Against the eager JAX forward, within the runtime tolerance of
    tests/test_torch_llama.py (3% of the largest logit): the two attentions
    round their probabilities to bf16 at other points, and a sandwich norm
    scales the small attention output, with those one-ulp differences, up
    to the size of the residual stream. Each set of tensors moves the
    logits by more than 5 times that, so none can be dropped unnoticed.
    Biased gate/up are never fused (q/k/v still are)."""
    n_vocab = t_config(t_load_gguf(base).metadata).n_vocab
    path = _rewrite(base, tmp_path / "extra.gguf", _extras(n_vocab, WHICH[which]))
    jl, tl, tp = _logits(path, fuse)
    tol = 3e-2 * float(np.abs(jl).max())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    plain, _, _ = _logits(base, fuse)
    assert np.abs(plain - jl).max() > 5 * tol
    blk = tp["blocks"][0]
    biased = "ffn_gate.bias" in WHICH[which]
    assert ("ffn_gate" in blk) == (biased or not fuse)
    assert ("wqkv" in blk) == fuse


def test_greedy_with_extra_tensors_runs_in_the_runtime(base, tmp_path):
    n_vocab = t_config(t_load_gguf(base).metadata).n_vocab
    path = _rewrite(base, tmp_path / "all.gguf", _extras(n_vocab, WHICH["all"]))
    rt = TRuntime.from_gguf(path, device="cpu")
    _, toks = rt.generate_greedy_on_device(PROMPT[0].tolist(), 4, stop_at_eos=False)
    assert len(toks) == 4 and all(0 <= t < n_vocab for t in toks)


@pytest.mark.parametrize("name", ["blk.0.attn_norm.bias", "blk.1.ffn_norm.bias",
                                  "blk.0.some_new_tensor.weight", "blk.2.attn_q.weight"])
def test_unconsumed_block_tensor_raises(base, tmp_path, name):
    """A block tensor the port does not apply (a LayerNorm bias, an unknown
    name, a layer past block_count) stops the load and names the tensor."""
    path = _rewrite(base, tmp_path / "odd.gguf",
                    {name: np.ones(N_EMBD, np.float32)})
    tg = t_load_gguf(path)
    with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
        TLM.load_llama_params(tg, t_config(tg.metadata), "cpu")
