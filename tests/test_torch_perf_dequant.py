"""The port's dequant microbenchmark tool (kernel 16, the pair form of the
planar GEMM) against the JAX package's ``tools/perf_dequant.py``."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.tools import perf_dequant as JP
from ik_llama_cpp_tpu_torch.ops.qmatmul import qmatmul, qmatmul_ref
from ik_llama_cpp_tpu_torch.tools import perf_dequant as TP

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


def _case(m, k, n, seed=0, lim=127):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-lim, lim + 1, (k, n), dtype=np.int8)
    scale = (rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, codes, scale


@pytest.mark.parametrize("shape", [(64, 32), (256, 1024), (7, 2)])
def test_pack_pairs_equals_jax_tool(shape):
    codes = np.random.default_rng(shape[0]).integers(-128, 128, shape, dtype=np.int8)
    got, ref = TP.pack_pairs(codes), JP.pack_pairs(codes)
    assert got.dtype == ref.dtype == np.int16 and got.shape == (shape[0], shape[1] // 2)
    assert got.tobytes() == ref.tobytes()
    back = TP.unpack_pairs(torch.from_numpy(got))
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_pair_ref_matches_jax_kernel(monkeypatch, sdt):
    """The plain version against the Pallas kernel in interpret mode at
    M 16, K 256, N 1024 with 512-wide column blocks. The JAX tool's wrapper
    has no interpret switch, so ``pallas_call`` gets it here. Both dequantize
    in bf16 and sum exact products in float32: the planar GEMM's tolerance."""
    monkeypatch.setattr(JP.pl, "pallas_call",
                        functools.partial(JP.pl.pallas_call, interpret=True))
    x, codes, scale = _case(16, 256, 1024, seed=1)
    packed = TP.pack_pairs(codes)
    jsc = jnp.asarray(scale, jnp.bfloat16 if sdt == torch.bfloat16 else jnp.float32)
    ref = np.asarray(JP.qmatmul_pair(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jsc,
                                     group=32, bm=16, bn=512, bk=256))
    got = TP.qmatmul_pair(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(scale).to(sdt), group=32).numpy()
    assert got.shape == (16, 1024)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_pair_ref_equals_planar_ref_on_unpacked_codes():
    x, codes, scale = _case(5, 128, 64, seed=2)
    packed = torch.from_numpy(TP.pack_pairs(codes))
    got = TP.qmatmul_pair_ref(torch.from_numpy(x), packed, torch.from_numpy(scale))
    ref = qmatmul_ref(torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(scale))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_tool_refuses_to_time_on_the_cpu():
    """``main`` measures the card: without one it stops, it does not time
    the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        TP.main(["--reps", "1"])


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("m", [1, 16, 64])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_pair_kernel_matches_plain_and_planar_kernel(m, sdt):
    x, codes, scale = _case(m, 512, 1088, seed=m)        # N/2 = 544 = 17 * 32
    xc = torch.from_numpy(x).cuda().to(torch.bfloat16)
    packed = torch.from_numpy(TP.pack_pairs(codes)).cuda()
    sc = torch.from_numpy(scale).cuda().to(sdt)
    got = TP.qmatmul_pair(xc, packed, sc)
    torch.testing.assert_close(got, TP.qmatmul_pair_ref(xc, packed, sc), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, qmatmul(xc, torch.from_numpy(codes).cuda(), sc))
