"""The port's 4-bit packed weights against the JAX package: ``pack_int4``
bit for bit, ``qmatmul4_ref`` against the JAX oracle and the Pallas kernel
in interpret mode, and ``QLinearI4`` through load, fuse and
``params_from_numpy``. The CUDA kernel is held against the plain version on
the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.ops import qmatmul as JQM
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQM

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

IQ4NL = np.array([-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113])


def codes_of(kind, k, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "dense":                      # Q4_0-class: all 16 values of [-8, 7]
        return rng.integers(-8, 8, (k, n)).astype(np.int8)
    if kind == "sparse":                     # [-8, 7] but only 9 values: codebook
        return (rng.integers(0, 9, (k, n)) - 4).astype(np.int8)
    if kind == "codebook":                   # IQ4_NL-class levels
        return IQ4NL[rng.integers(0, 16, (k, n))].astype(np.int8)
    if kind == "five":                       # a 5-value codebook, padded with its max
        return np.array([-90, -3, 0, 7, 100])[rng.integers(0, 5, (k, n))].astype(np.int8)
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["dense", "sparse", "codebook", "five"])
def test_pack_int4_bit_exact(kind):
    codes = codes_of(kind, 64, 24, seed=1)
    jp, jl = JQM.pack_int4(codes)
    tp, tl = TQM.pack_int4(codes)
    assert tp.dtype == np.uint8 and tp.shape == (32, 24)
    np.testing.assert_array_equal(tp, jp)
    assert tl == jl and (tl is None) == (kind == "dense")
    # the packed form decodes back to the codes
    idx = TQM.unpack_int4(torch.from_numpy(tp)).numpy()
    vals = idx - 8 if tl is None else np.asarray(tl)[idx]
    np.testing.assert_array_equal(vals.astype(np.int8), codes)


def test_pack_int4_unpackable():
    rng = np.random.default_rng(2)
    wide = rng.integers(-20, 20, (64, 8)).astype(np.int8)        # 40 values
    odd = rng.integers(-8, 8, (63, 8)).astype(np.int8)           # odd K
    for c in (wide, odd):
        assert TQM.pack_int4(c) is None and JQM.pack_int4(c) is None


def _operands(kind, m, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    packed, lut = TQM.pack_int4(codes_of(kind, k, n, seed))
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale = rng.uniform(0.005, 0.02, (k // 32, n)).astype(np.float32)
    b = (rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32) if bias else None
    return x, packed, scale, b, lut


@pytest.mark.parametrize("kind,bias", [("dense", False), ("dense", True),
                                       ("codebook", False), ("five", True)])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_qmatmul4_ref_matches_jax(kind, bias, m):
    """Against the JAX oracle and the Pallas kernel in interpret mode. All
    three form the same bf16 weights and sum exact bf16 products in
    float32, in different orders: 16 sqrt(K) float32 roundings of the
    largest sum of |x w|."""
    k, n = 512, 96
    x, packed, scale, b, lut = _operands(kind, m, k, n, bias, seed=m)
    tb = None if b is None else torch.from_numpy(b).to(torch.bfloat16)
    got = TQM.qmatmul4(torch.from_numpy(x), torch.from_numpy(packed),
                       torch.from_numpy(scale).to(torch.bfloat16), tb, lut16=lut).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale, jnp.bfloat16),
             None if b is None else jnp.asarray(b, jnp.bfloat16))
    ref = np.asarray(JQM.qmatmul4_ref(*jargs, lut16=lut))
    ker = np.asarray(JQM.qmatmul4(*jargs, lut16=lut, block_m=16, block_n=128,
                                  block_k=128, interpret=True))
    tol = 16 * k ** 0.5 * 2.0 ** -24 * float(np.abs(ref).max()) * 8
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert np.abs(got - ref).max() <= tol
    assert np.abs(got - ker).max() <= tol


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("tiny4") / "tiny.gguf",
                                seed=5, n_embd=256, n_head=2, n_head_kv=1,
                                n_ff=512, quant=GGMLType.Q4_0)


@pytest.fixture
def pack4():
    JW.set_pack_int4(True)
    TW.set_pack_int4(True)
    yield
    JW.set_pack_int4(False)
    TW.set_pack_int4(False)


def _numpy_tree(p):
    if isinstance(p, JW.QLinearI4):
        return {"type": "QLinearI4", "packed": np.asarray(p.packed),
                "scale": np.asarray(p.scale), "group": p.group, "lut16": p.lut16,
                "bias": None if p.bias is None else np.asarray(p.bias)}
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


@pytest.mark.parametrize("fuse", [True, False])
def test_qlinear_i4_load_fuse_and_convert(tiny, pack4, fuse):
    """Every Q4_0 block linear loads as QLinearI4 (before the int8 branch,
    whatever the int8 setting), fuses, and equals the JAX package's, buffer
    for buffer; the Q6_K head of the fixture has 64 code values and stays."""
    TW.set_i8_mxu(True)
    try:
        tg = t_load_gguf(tiny)
        tp = TLM.load_llama_params(tg, t_config(tg.metadata), "cpu", fuse=fuse)
    finally:
        TW.set_i8_mxu(None)
    jg = j_load_gguf(tiny)
    jp = JLM.load_llama_params(jg, j_config(jg.metadata), fuse=fuse)
    blk = tp["blocks"][0]
    names = ("wqkv", "wo", "ffn_up", "ffn_down") if fuse else \
        ("wq", "wk", "wv", "wo", "ffn_gate", "ffn_up", "ffn_down")
    for name in names:
        t_lin, j_lin = blk[name], jp["blocks"][0][name]
        assert isinstance(t_lin, TW.QLinearI4) and isinstance(j_lin, JW.QLinearI4), name
        assert t_lin.lut16 == j_lin.lut16 and t_lin.group == j_lin.group
        np.testing.assert_array_equal(t_lin.packed.numpy(), np.asarray(j_lin.packed))
        np.testing.assert_array_equal(t_lin.scale.float().numpy(),
                                      np.asarray(j_lin.scale, np.float32))
    assert type(tp["output"]).__name__ == type(jp["output"]).__name__
    conv = params_from_numpy(_numpy_tree(jp), "cpu")
    for name in names:
        a, b = conv["blocks"][0][name], blk[name]
        assert isinstance(a, TW.QLinearI4) and a.lut16 == b.lut16 and a.group == b.group
        for (ka, va), (kb, vb) in zip(a.named_buffers(), b.named_buffers()):
            assert ka == kb and va.dtype == vb.dtype and torch.equal(va, vb), (name, ka)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 256)).astype(np.float32))
    name = names[0]
    np.testing.assert_allclose(blk[name](x).numpy(),
                               np.asarray(jp["blocks"][0][name](jnp.asarray(x.numpy()))),
                               rtol=0, atol=1e-4)


def test_fuse_refuses_mixed_codebooks():
    def lin(lut, bias=False):
        k, n = 64, 8
        return TW.QLinearI4(torch.zeros((k // 2, n), dtype=torch.uint8),
                            torch.ones((k // 32, n), dtype=torch.bfloat16),
                            torch.ones((k // 32, n), dtype=torch.bfloat16) if bias else None,
                            group=32, lut16=lut)
    lut = tuple(float(i) for i in range(16))
    assert TW.fuse_linears([lin(None), lin(lut)]) is None
    assert TW.fuse_linears([lin(None), lin(None, bias=True)]) is None
    fused = TW.fuse_linears([lin(lut, True), lin(lut, True)])
    assert isinstance(fused, TW.QLinearI4) and fused.packed.shape == (32, 16)
    assert fused.bias.shape == (2, 16) and fused.lut16 == lut
    assert TW.fuse_linears([lin(None), TW.DenseLinear(torch.zeros(64, 8))]) is None


@needs_cuda
@pytest.mark.parametrize("kind,bias", [("dense", False), ("dense", True),
                                       ("codebook", False), ("five", True)])
@pytest.mark.parametrize("m,k,n", [(1, 512, 96), (8, 4096, 1024), (70, 96, 72), (512, 1024, 256)])
def test_qmatmul4_kernel_matches_plain(kind, bias, m, k, n):
    x, packed, scale, b, lut = _operands(kind, m, k, n, bias, seed=3)
    args = [torch.from_numpy(x).cuda(), torch.from_numpy(packed).cuda(),
            torch.from_numpy(scale).to(torch.bfloat16).cuda(),
            None if b is None else torch.from_numpy(b).to(torch.bfloat16).cuda()]
    got = TQM.qmatmul4(*args, lut16=lut)
    ref = TQM.qmatmul4_ref(*args, lut16=lut)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()) + 1e-5
