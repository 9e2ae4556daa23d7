"""The port's quantized matmuls against the JAX package.

The plain versions (what a CPU tensor runs) are held against the Pallas
kernels in interpret mode and against the JAX oracles, with the tolerances
the JAX package's own tests use. The CUDA kernels are held against the plain
versions on the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.ops import qmatmul as JQ
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQ

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


def _i8_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (k, n), dtype=np.int8)
    scale = (rng.random((k // 32, n), dtype=np.float32) * 0.1).astype(np.float32)
    q8, sw = TQ.requant_supergroup(codes, scale)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, q8, sw


def test_requant_supergroup_is_the_jax_recode():
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, (512, 96), dtype=np.int8)
    scale = (rng.random((16, 96), dtype=np.float32) * 0.1).astype(np.float32)
    q8, sw = TQ.requant_supergroup(codes, scale)
    jq, jsw = JQ.requant_supergroup(codes, scale)
    np.testing.assert_array_equal(q8, jq)
    np.testing.assert_array_equal(sw, jsw)


@pytest.mark.parametrize("m", [1, 5, 24, 300])
def test_quantize_activations_bit_exact(m):
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, 512)) * rng.uniform(0.01, 10, (m, 1))).astype(np.float32)
    x[0, :256] = 0.0                          # an all-zero supergroup
    x[-1, 256:264] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0, 63.5]  # ties
    tq, ts = TQ.quantize_activations(torch.from_numpy(x))
    jq, js = JQ.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m", [1, 5, 24, 300])
def test_qmatmul_i8_plain_matches_jax(m):
    """Kernel A's function: the plain version against the Pallas kernel
    (interpret mode), the XLA qmatmul_i8 and the JAX oracle."""
    x, q8, sw = _i8_case(m, 512, 256, 7)
    xq, xs = TQ.quantize_activations(torch.from_numpy(x))
    got = TQ.qmatmul_i8(xq, xs, torch.from_numpy(q8), torch.from_numpy(sw)).numpy()
    jxq, jxs = jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy())
    refs = [JQ.qmatmul_i8_ref(jxq, jxs, jnp.asarray(q8), jnp.asarray(sw)),
            JQ.qmatmul_i8(jxq, jxs, jnp.asarray(q8), jnp.asarray(sw))]
    if m >= 24:   # the Pallas kernel's prefill shapes (interpret mode is slow)
        refs.append(JQ.qmatmul_i8_mxu(jxq, jxs.T, jnp.asarray(q8), jnp.asarray(sw),
                                      interpret=True))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n,bias", [(5, 256, 128, False), (5, 256, 128, True),
                                        (33, 768, 96, True), (1, 160, 40, False)])
def test_qmatmul_plain_matches_jax(m, k, n, bias):
    """Kernel D's function: the plain version against the Pallas kernel
    (interpret mode) and qmatmul_ref, on aligned and unaligned shapes."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    codes = rng.integers(-127, 128, (k, n), dtype=np.int8)
    scale = (rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32)
    b = (rng.standard_normal((k // 32, n)) * 0.02).astype(np.float32) if bias else None
    got = TQ.qmatmul(torch.from_numpy(x), torch.from_numpy(codes),
                     torch.from_numpy(scale).to(torch.bfloat16),
                     None if b is None else torch.from_numpy(b).to(torch.bfloat16)
                     ).numpy()
    jb = None if b is None else jnp.asarray(b)
    ref = JQ.qmatmul_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale), jb)
    ker = JQ.qmatmul(x, codes, scale, None if b is None else b, group=32,
                     interpret=True, block_m=32, block_n=128, block_k=256)
    for r in (ref, ker):
        np.testing.assert_allclose(got, np.asarray(r), rtol=1e-5, atol=1e-4)


def test_qlinear_i8_with_group_bias_matches_jax():
    """QLinearI8 with the per-group bias of asymmetric formats (gbias)."""
    rng = np.random.default_rng(2)
    k, n, m = 512, 256, 8
    codes = rng.integers(0, 16, (k, n), dtype=np.int8)
    scale = (0.02 + rng.random((k // 32, n)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32)
    q8, sw = JQ.requant_supergroup(codes, scale)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    jl = JW.QLinearI8(jnp.asarray(q8), jnp.asarray(sw), jnp.asarray(bias, jnp.bfloat16))
    tl = TW.QLinearI8(torch.from_numpy(q8), torch.from_numpy(sw),
                      torch.from_numpy(bias).to(torch.bfloat16))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                               np.asarray(jl(jnp.asarray(x))), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("m", [1, 8, 40, 512])
def test_qmatmul_i8_kernel_matches_plain(m):
    x, q8, sw = _i8_case(m, 1024, 200, 3)
    dev = "cuda"
    xq, xs = TQ.quantize_activations(torch.from_numpy(x).to(dev))
    codes = torch.from_numpy(q8.T.copy()).to(dev).t()
    swt = torch.from_numpy(sw).to(dev)
    got = TQ.qmatmul_i8(xq, xs, codes, swt)
    ref = TQ.qmatmul_i8_ref(xq, xs, codes, swt)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("m,k,n,bias", [(1, 256, 128, True), (40, 160, 72, False),
                                        (512, 1024, 192, True)])
def test_qmatmul_kernel_matches_plain(m, k, n, bias):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(m, k, generator=g).cuda().to(torch.bfloat16)
    codes = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8).cuda()
    scale = (torch.rand(k // 32, n, generator=g) * 0.02).to(torch.bfloat16).cuda()
    b = (torch.randn(k // 32, n, generator=g) * 0.01).to(torch.bfloat16).cuda() if bias else None
    torch.testing.assert_close(TQ.qmatmul(x, codes, scale, b),
                               TQ.qmatmul_ref(x, codes, scale, b), rtol=1e-4, atol=1e-4)
