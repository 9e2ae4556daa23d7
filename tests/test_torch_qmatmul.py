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


@pytest.mark.parametrize("group", [16, 32, 256])
def test_requant_rows_is_the_jax_recode_transposed(group):
    """The loader's torch recode (rows, in chunks) gives the numpy recode's
    bits: Q4_0-like and Q8_0-like codes, an all-zero supergroup, ties."""
    rng = np.random.default_rng(group)
    n, k = 300, 768
    codes = rng.integers(-128, 128, (n, k), dtype=np.int8)
    codes[3, 256:512] = 0
    codes[5, :256] = np.tile(np.asarray([127, -127, 64, -64], np.int8), 64)
    scale = (rng.random((n, k // group), dtype=np.float32) * 0.05).astype(np.float32)
    q8, sw = TQ.requant_rows(codes, scale, group, "cpu", chunk=128)
    jq, jsw = JQ.requant_supergroup(codes.T, scale.T, group=group)
    np.testing.assert_array_equal(q8.numpy(), jq.T)
    np.testing.assert_array_equal(sw.numpy(), jsw.T)


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


@pytest.mark.parametrize("m", [1, 5, 16, 24, 300])
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


@pytest.mark.parametrize("c", [127.0, 7.0, 31.0, -127.0])
def test_true_div_is_a_float32_division(c):
    """The scale of every quantizer is amax / c as a float32 division, what
    numpy and the JAX functions give; multiplying by the rounded reciprocal
    would differ on some of these values."""
    from ik_llama_cpp_tpu_torch.ops.qmatmul import true_div
    x = np.abs(np.random.default_rng(0).standard_normal(4096)).astype(np.float32) * 3
    got = true_div(torch.from_numpy(x), c).numpy()
    np.testing.assert_array_equal(got, x / np.float32(c))
    assert (got != x * (np.float32(1.0) / np.float32(c))).any()
    assert true_div(torch.from_numpy(x), c).dtype == torch.float32


@needs_cuda
def test_quantizers_give_the_cpu_bits_on_the_card():
    """Scales and codes of the activation quantizer, the h requantization
    and the four KV encoders on the card equal the CPU's bit for bit (a
    division by a Python scalar would be a reciprocal multiplication there)."""
    from ik_llama_cpp_tpu_torch.ops.kv_quant import KV_ENCODERS
    from ik_llama_cpp_tpu_torch.ops.moe_decode import requant_by_inverse
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((64, 1024)) * 3).astype(np.float32))
    for fn in (TQ.quantize_activations, requant_by_inverse):
        (qc, sc), (qg, sg) = fn(x), fn(x.cuda())
        assert torch.equal(sc, sg.cpu()) and torch.equal(qc, qg.cpu()), fn.__name__
    kv = x.reshape(2, 32, 8, 128)
    for name, enc in KV_ENCODERS.items():
        (qc, sc), (qg, sg) = enc(kv), enc(kv.cuda())
        assert torch.equal(sc, sg.cpu()) and torch.equal(qc, qg.cpu()), name


# ------------------------------------------------ the M <= 16 split plan --
PLAN_SHAPES = [(1, 6144, 4096, 32), (1, 4096, 4096, 32), (1, 28672, 4096, 32),
               (16, 4096, 14336, 32), (16, 14336, 4096, 32), (5, 2048, 1408, 32),
               (1, 4000, 4096, 16), (2, 1000, 1408, 32), (8, 151936, 2048, 32),
               (1, 4096, 4096, 256), (16, 64, 32, 32)]


@pytest.mark.parametrize("m,n,k,group", PLAN_SHAPES)
def test_gemv_plan_covers_every_group_once(m, n, k, group):
    """The K ranges of a cluster's warps are whole groups, in order, and
    together cover K exactly once; the tiles cover N; the block's sum of its
    warps' partials fits in static shared memory."""
    plan = TQ.gemv_plan(m, n, k, group)
    assert 1 <= plan["splits"] <= TQ.GEMV_MAX_SPLITS
    assert plan["tiles"] * TQ.GEMV_COLS >= n > (plan["tiles"] - 1) * TQ.GEMV_COLS
    assert plan["m_tiles"] * 8 >= m
    assert plan["smem"] <= TQ.SMEM_LIMIT
    ranges = TQ.gemv_k_ranges(k, group, plan["splits"])
    assert len(ranges) == plan["splits"] * TQ.GEMV_WARPS
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:] + [(k, k)]):
        assert lo % group == 0 and hi % group == 0 and lo <= hi == lo2
    covered = np.zeros(k // group, np.int64)
    for lo, hi in ranges:
        covered[lo // group: hi // group] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n,k,want", [(4096, 4096, 7), (6144, 4096, 4), (28672, 4096, 1),
                                      (14336, 4096, 2), (151936, 4096, 1), (2048, 1408, 8),
                                      (4096, 256, 2)])
def test_gemv_plan_fills_the_card(n, k, want):
    """The K split keeps a launch at about 1.7 blocks a streaming
    multiprocessor (224), at most a cluster of 8, and never leaves a warp
    without a group."""
    plan = TQ.gemv_plan(1, n, k, 32)
    assert plan["splits"] == want
    assert plan["splits"] * TQ.GEMV_WARPS <= k // 32
    assert plan["tiles"] * plan["splits"] <= TQ.GEMV_BLOCKS or plan["splits"] == 1


@pytest.mark.parametrize("m,group", [(17, 32), (0, 32), (4, 8), (1, 24)])
def test_gemv_plan_refuses_what_the_kernel_does_not_take(m, group):
    with pytest.raises(ValueError, match="group % 16"):
        TQ.gemv_plan(m, 4096, 96 * group, group)


GEMV_CASES = [(2000, torch.bfloat16, False), (2000, torch.float32, True),
              (1000, torch.bfloat16, True), (4096, torch.float32, False)]


def _planar_case(m, k, n, sdt, bias, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16)
    codes = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    # weights of the size test_qmatmul_kernel_matches_plain uses (codes in
    # -8 .. 7, scales up to 0.02), for its tolerance
    scale = (torch.rand(k // 32, n, generator=g) * 0.02 / 16).to(sdt)
    b = (torch.randn(k // 32, n, generator=g) * 0.01).to(sdt) if bias else None
    return [t if t is None else t.cuda() for t in (x, codes, scale, b)]


@needs_cuda
@pytest.mark.parametrize("n,sdt,bias", GEMV_CASES)
@pytest.mark.parametrize("k", [1408, 4096])
@pytest.mark.parametrize("m", [1, 2, 5, 16, 17])
def test_qmatmul_decode_kernel_matches_plain(m, k, n, sdt, bias):
    """M <= 16 runs the GEMV kernel (M 17 the tiled one): every code byte
    (-128 .. 127), a ragged N (2000: a partial tile; 1000: rows not 16-byte
    aligned), f32 and bf16 scales, a group bias."""
    x, codes, scale, b = _planar_case(m, k, n, sdt, bias, m * k + n)
    torch.testing.assert_close(TQ.qmatmul(x, codes, scale, b),
                               TQ.qmatmul_ref(x, codes, scale, b), rtol=1e-4, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("m", [1, 16])
def test_qmatmul_decode_kernel_repeats_bit_for_bit(m):
    """The K split adds its partial sums in a fixed order: no atomics."""
    x, codes, scale, b = _planar_case(m, 4096, 4096, torch.bfloat16, True, 9)
    first = TQ.qmatmul(x, codes, scale, b)
    for _ in range(3):
        assert torch.equal(TQ.qmatmul(x, codes, scale, b), first)
