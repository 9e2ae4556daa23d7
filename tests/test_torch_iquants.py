"""The codebook i-quants (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S,
IQ1_M) in the port against the JAX package on the CPU: the port's decoder
gives the JAX decoder's floats bit for bit, on random block bytes and on
blocks the JAX encoder wrote; and a tiny llama GGUF whose block linears the
JAX encoder wrote as IQ2_XXS loads in the port as bf16 dense linears and
gives the JAX logits (the rule of test_torch_archs.py)."""
import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.gguf.constants import GEOMETRY, GGMLType
from ik_llama_cpp_tpu.quant.dequant import dequantize as j_dequantize
from ik_llama_cpp_tpu.quant.quantize import quantize as j_quantize
from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType as TGGMLType
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu_torch.models.weights import DenseLinear, dequant_tensor
from ik_llama_cpp_tpu_torch.quant.dequant import dequantize
from test_torch_archs import check_arch

TYPES = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M"]
N = 512          # two 256-value blocks a row


@pytest.mark.parametrize("name", TYPES)
def test_random_blocks_decode_bit_for_bit(name):
    """Random bytes as 6 rows of 2 blocks: every float, non-finite ones
    from random f16 scales included, equals the JAX decoder's."""
    t = GGMLType[name]
    nbytes = 6 * (N // GEOMETRY[t].block_elems) * GEOMETRY[t].block_bytes
    data = np.random.default_rng(TYPES.index(name)).integers(0, 256, nbytes, dtype=np.uint8)
    with np.errstate(over="ignore", invalid="ignore"):
        want = j_dequantize(data, t, N)
    got = dequantize(data, TGGMLType[name], N)
    assert got.dtype == want.dtype == np.float32 and got.shape == (6, N)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", TYPES)
def test_encoded_blocks_decode_bit_for_bit(name):
    """Blocks the JAX encoder wrote from Gaussian weights."""
    t = GGMLType[name]
    x = np.random.default_rng(7).standard_normal((4, N)).astype(np.float32)
    data = j_quantize(x, t)
    want = j_dequantize(data, t, N)
    np.testing.assert_array_equal(dequantize(data, TGGMLType[name], N), want)
    assert np.isfinite(want).all() and np.abs(want - x).mean() < np.abs(x).mean()


def _iq2_xxs_llama(path):
    """The tiny llama (one layer, width 256) with every block linear
    re-encoded by the JAX encoder as IQ2_XXS; embedding and head stay F16."""
    src = t_load_gguf(F.make_tiny_llama_gguf(f"{path}.src", n_layer=1, n_embd=256,
                                             n_ff=256))
    w = GGUFWriter(path)
    for key, val in src.metadata.items():
        w.add(key, val)
    for name, info in src.tensors.items():
        if name.startswith("blk.") and len(info.shape) == 2:
            x = dequant_tensor(info)
            w.add_tensor(name, j_quantize(x, GGMLType.IQ2_XXS), shape=info.shape,
                         ggml_type=TGGMLType.IQ2_XXS)
        else:
            w.add_tensor(name, info.data, shape=info.shape, ggml_type=info.ggml_type)
    w.write()
    return path


def test_iq2_xxs_llama_matches_jax_logits(tmp_path):
    path = _iq2_xxs_llama(tmp_path / "iq2.gguf")
    types = {info.ggml_type.name for n, info in t_load_gguf(path).tensors.items()
             if n.startswith("blk.0.attn_q") or n.startswith("blk.0.ffn_down")}
    assert types == {"IQ2_XXS"}
    _, tr, _, _ = check_arch(path)
    blk = tr.params["blocks"][0]
    assert all(isinstance(blk[k], DenseLinear) for k in ("wqkv", "wo", "ffn_up", "ffn_down"))
