"""The port's GGUF, quantizer and weight loading against the JAX package:
the same file gives the same codes, scales and supergroup recodes."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu.gguf.constants import GGMLType as JType
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.gguf.writer import GGUFWriter as JWriter
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.quant.quantize import quantize as j_quantize

from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType as TType
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter as TWriter
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.quant.quantize import quantize as t_quantize


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("ttype", ["Q8_0", "Q4_0"])
def test_quantize_matches_jax_bytes(ttype):
    x = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    got = t_quantize(x, TType[ttype])
    ref = j_quantize(x, JType[ttype])
    np.testing.assert_array_equal(got, ref)


def test_quantize_refuses_other_types():
    with pytest.raises(NotImplementedError):
        t_quantize(np.zeros((1, 256), np.float32), TType.Q4_K)


def test_writer_reader_roundtrip_across_packages(tmp_path):
    """A file the port writes reads the same in both packages, and back."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    path = tmp_path / "port.gguf"
    tw = TWriter(path, arch="llama")
    tw.add("llama.block_count", 1)
    tw.add("general.name", "port")
    tw.add_tensor("a.weight", t_quantize(w, TType.Q4_0), shape=(256, 64),
                  ggml_type=TType.Q4_0)
    tw.add_tensor("b.weight", w[0])
    tw.write()
    for load in (t_load_gguf, j_load_gguf):
        g = load(path)
        assert g.metadata["general.name"] == "port"
        assert int(g.metadata["llama.block_count"]) == 1
        np.testing.assert_array_equal(np.asarray(g.tensors["a.weight"].data),
                                      t_quantize(w, TType.Q4_0))
        np.testing.assert_array_equal(
            np.asarray(g.tensors["b.weight"].data).view(np.float32), w[0])


def _weights_file(tmp_path):
    """Tensors of several planar formats, K a multiple of 256 (int8 path)
    and not (planar path), written with the JAX package's writer."""
    rng = np.random.default_rng(2)
    path = tmp_path / "w.gguf"
    jw = JWriter(path, arch="llama")
    jw.add("llama.block_count", 1)
    specs = {"q40": (JType.Q4_0, 96, 512), "q80": (JType.Q8_0, 64, 256),
             "q41": (JType.Q4_1, 48, 512), "q4k": (JType.Q4_K, 32, 256),
             "odd": (JType.Q4_0, 40, 160), "f16": (JType.F16, 24, 64)}
    for name, (tt, n, k) in specs.items():
        a = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
        jw.add_tensor(name, j_quantize(a, tt), shape=(k, n), ggml_type=tt)
    jw.write()
    return path, list(specs)


@pytest.mark.parametrize("i8", [False, True])
def test_load_linear_identical(tmp_path, i8):
    path, names = _weights_file(tmp_path)
    jg, tg = j_load_gguf(path), t_load_gguf(path)
    JW.set_i8_mxu(i8)
    TW.set_i8_mxu(i8)
    try:
        for name in names:
            jl = JW.load_linear(jg.tensors[name])
            tl = TW.load_linear(tg.tensors[name], "cpu")
            assert type(jl).__name__ == type(tl).__name__, name
            if isinstance(tl, TW.QLinearI8):
                np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
                assert tl.codes_t.is_contiguous() and tl.codes.shape == jl.codes.shape
                np.testing.assert_array_equal(tl.sw.numpy(), np.asarray(jl.sw))
                assert (tl.gbias is None) == (jl.gbias is None)
                if tl.gbias is not None:
                    np.testing.assert_array_equal(_f32(tl.gbias), _f32(jl.gbias))
            elif isinstance(tl, TW.QLinear):
                np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
                np.testing.assert_array_equal(_f32(tl.scale), _f32(jl.scale))
                assert (tl.bias is None) == (jl.bias is None)
                if tl.bias is not None:
                    np.testing.assert_array_equal(_f32(tl.bias), _f32(jl.bias))
                assert tl.group == jl.group
            else:
                np.testing.assert_array_equal(_f32(tl.w), _f32(jl.w))
    finally:
        JW.set_i8_mxu(None)
        TW.set_i8_mxu(None)


def test_int8_path_default_follows_device():
    assert TW.i8_enabled("cuda") and not TW.i8_enabled("cpu")


def test_fuse_linears_concatenates(tmp_path):
    path, _ = _weights_file(tmp_path)
    tg = t_load_gguf(path)
    TW.set_i8_mxu(True)
    try:
        a = TW.load_linear(tg.tensors["q40"], "cpu")
        b = TW.load_linear(tg.tensors["q40"], "cpu")
        f = TW.fuse_linears([a, b])
        assert f.codes.shape == (512, 192) and f.codes_t.is_contiguous()
        x = torch.randn(3, 512)
        torch.testing.assert_close(f(x), torch.cat([a(x), b(x)], dim=-1))
        assert TW.fuse_linears([a, TW.load_linear(tg.tensors["q80"], "cpu")]) is None
    finally:
        TW.set_i8_mxu(None)
