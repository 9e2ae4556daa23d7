"""Kernel 15 at M <= 16 (``qmatmul4_gemv_kernel``): its launch plan, a plain
model of its order of sums and of its in-register unpack, held against the
JAX package and the port's plain version on the CPU; the kernel itself
against the plain version on the card (skipped without one)."""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import qmatmul as JQM
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQM

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

IQ4NL = (-127.0, -104.0, -83.0, -65.0, -49.0, -35.0, -22.0, -10.0,
         1.0, 13.0, 25.0, 38.0, 53.0, 69.0, 89.0, 113.0)

# ------------------------------------------------------------- the plan --
# (m, n, k, group): the four decode shapes of the dense 8B model, the head,
# a partial column tile, group 16 and 64, a K just one unit a warp
PLAN_SHAPES = [(1, 6144, 4096, 32), (1, 4096, 4096, 32), (1, 28672, 4096, 32),
               (1, 4096, 14336, 32), (16, 4096, 14336, 32), (8, 32000, 4096, 32),
               (5, 4000, 4096, 16), (2, 1000, 1408, 32), (16, 256, 1024, 64),
               (1, 96, 512, 16), (3, 128, 128, 32)]


@pytest.mark.parametrize("m,n,k,group", PLAN_SHAPES)
def test_gemv4_plan_covers_every_unit_once(m, n, k, group):
    """A warp's K range is whole units of lcm(group, 32) rows (whole groups
    and whole 32-row steps), in order, and the ranges of a cluster cover K
    exactly once; the tiles cover N; the shared memory fits."""
    plan = TQM.gemv4_plan(m, n, k, group)
    assert plan["kernel"] == "gemv"
    unit = plan["unit"]
    assert unit % group == 0 and unit % TQM.GEMV4_STEP == 0 and unit == math.lcm(group, 32)
    assert 1 <= plan["splits"] <= TQM.GEMV_MAX_SPLITS
    assert plan["tiles"] * TQM.GEMV_COLS >= n > (plan["tiles"] - 1) * TQM.GEMV_COLS
    assert plan["m_tiles"] * 8 >= m and plan["smem"] <= TQM.SMEM_LIMIT
    ranges = TQM.gemv_k_ranges(k, unit, plan["splits"])
    assert len(ranges) == plan["splits"] * TQM.GEMV_WARPS
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    covered = np.zeros(k // group, np.int64)
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:] + [(k, k)]):
        assert lo % unit == 0 and hi % unit == 0 and lo <= hi == lo2
        covered[lo // group: hi // group] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,n,k,group,want", [
    (1, 6144, 4096, 32, 4), (1, 4096, 4096, 32, 7), (1, 4096, 14336, 32, 7),
    (16, 6144, 4096, 32, 4), (16, 4096, 14336, 32, 7), (1, 256, 1024, 64, 4),
    (1, 128, 128, 32, 1), (1, 2048, 1024, 16, 8),
    # one block a tile by the 224-block rule: two at M <= 8 within one wave
    (1, 28672, 4096, 32, 2), (8, 32000, 4096, 32, 2), (16, 28672, 4096, 32, 1),
    (1, 151936, 4096, 32, 1), (1, 28672, 128, 32, 1)])
def test_gemv4_plan_splits(m, n, k, group, want):
    """Kernel D's rule on units (at most GEMV4_BLOCKS blocks, a cluster of
    at most 8, every warp at least one unit), and two blocks a tile at
    M <= 8 where that rule leaves one and the launch stays within one wave
    (GEMV4_WAVE)."""
    plan = TQM.gemv4_plan(m, n, k, group)
    assert plan["splits"] == want
    assert plan["splits"] * TQM.GEMV_WARPS <= max(TQM.GEMV_WARPS, k // plan["unit"])
    blocks = plan["tiles"] * plan["splits"]
    assert blocks <= TQM.GEMV4_BLOCKS or plan["splits"] == 1 or (
        plan["splits"] == 2 and plan["m_tiles"] == 1 and blocks <= TQM.GEMV4_WAVE)


@pytest.mark.parametrize("m,k,group", [(17, 4096, 32), (64, 4096, 32), (512, 4096, 32),
                                       (0, 4096, 32), (1, 4096, 8), (4, 4096, 2),
                                       (1, 4080, 24), (8, 144, 48), (1, 48, 16)])
def test_gemv4_plan_keeps_the_tiled_kernel(m, k, group):
    """M > 16, an even group below 16 or not a multiple of 16, or a K that
    is not a whole number of lcm(group, 32)-row units: the tiled kernel,
    named before the launch."""
    assert TQM.gemv4_plan(m, 4096, k, group) == {"kernel": "tiled"}


def test_gemv4_plan_group_48_takes_whole_units():
    plan = TQM.gemv4_plan(1, 4096, 192, 48)
    assert plan["kernel"] == "gemv" and plan["unit"] == 96


# ------------------------------------------------ the order of its sums --
def _operands(m, k, n, group, lut, bias, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale = rng.uniform(0.005, 0.02, (k // group, n)).astype(np.float32)
    if lut is not None:
        scale *= 0.1
    b = (rng.standard_normal((k // group, n)) * 0.01).astype(np.float32) if bias else None
    return x, packed, scale, b


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def kernel_model(x, packed, scale, bias, group, lut16):
    """The M <= 16 kernel's arithmetic in float32 on the CPU: the bf16
    weights of ``_dequant4_bf16``; each warp of the cluster sums its K range
    (the tensor core's order inside a range is not modelled); a block adds
    its 4 warps' partials in order, then the blocks are added in rank
    order."""
    m, k = x.shape
    n = packed.shape[1]
    plan = TQM.gemv4_plan(m, n, k, group)
    assert plan["kernel"] == "gemv"
    w = TQM._dequant4_bf16(torch.from_numpy(packed), _bf16(scale),
                           None if bias is None else _bf16(bias), group, lut16).float().numpy()
    xb = _bf16(x).float().numpy()
    parts = [xb[:, lo:hi] @ w[lo:hi] for lo, hi in
             TQM.gemv_k_ranges(k, plan["unit"], plan["splits"])]
    total = None
    for r in range(plan["splits"]):
        blk = parts[4 * r]
        for i in range(1, TQM.GEMV_WARPS):
            blk = blk + parts[4 * r + i]
        total = blk if total is None else total + blk
    return total.astype(np.float32), plan


MODEL_CASES = [(1, 32, None, False), (8, 32, IQ4NL, False), (16, 32, None, True),
               (1, 64, IQ4NL, True), (16, 64, None, False), (8, 16, None, True)]


@pytest.mark.parametrize("m,group,lut,bias", MODEL_CASES)
def test_kernel_model_matches_jax_and_plain(m, group, lut, bias):
    """The model against JAX ``qmatmul4`` (Pallas, interpret mode),
    ``qmatmul4_ref`` and the port's plain version, with a K split of
    several blocks. All form the same bf16 weights and sum exact bf16
    products in float32 in different orders: tolerance 16 sqrt(K) float32
    roundings of the largest sum of |x w|."""
    k, n = 1024, 256
    x, packed, scale, b = _operands(m, k, n, group, lut, bias, seed=m + group)
    got, plan = kernel_model(x, packed, scale, b, group, lut)
    assert plan["splits"] > 1
    jargs = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale, jnp.bfloat16),
             None if b is None else jnp.asarray(b, jnp.bfloat16))
    ref = np.asarray(JQM.qmatmul4_ref(*jargs, group=group, lut16=lut))
    ker = np.asarray(JQM.qmatmul4(*jargs, group=group, lut16=lut, block_m=16, block_n=128,
                                  block_k=128, interpret=True))
    plain = TQM.qmatmul4(torch.from_numpy(x), torch.from_numpy(packed), _bf16(scale),
                         None if b is None else _bf16(b), group=group, lut16=lut).numpy()
    w = TQM._dequant4_bf16(torch.from_numpy(packed), _bf16(scale),
                           None if b is None else _bf16(b), group, lut).float().numpy()
    absdot = float((np.abs(_bf16(x).float().numpy()) @ np.abs(w)).max())
    tol = 16 * k ** 0.5 * 2.0 ** -24 * absdot
    assert got.shape == (m, n)
    for other in (ref, ker, plain):
        assert np.abs(got - other).max() <= tol


# ---------------------------------------------------- the unpack, modelled --
def _bf16_bits(v):
    """float32 -> bf16 bits, round to nearest even (uint16)."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def _bits_to_f32(b):
    return (np.asarray(b, np.uint32) << 16).view(np.float32)


def _byte_perm(a, b, sel):
    pool = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                    + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def magic_pairs(w):
    """csrc/qmatmul4.cu magic_pairs on uint32 words: the bf16x2 {128 + lo,
    128 + hi} of each of the four bytes."""
    w = np.asarray(w, np.uint32)
    s = w >> 4
    lo01 = (w & 0x00000F0F) | 0x43430000
    hi01 = (s & 0x00000F0F) | 0x43430000
    lo23 = (w & 0x0F0F0000) | 0x00004343
    hi23 = (s & 0x0F0F0000) | 0x00004343
    return [_byte_perm(lo01, hi01, 0x3420), _byte_perm(lo01, hi01, 0x3521),
            _byte_perm(lo23, hi23, 0x1602), _byte_perm(lo23, hi23, 0x1703)]


def unpack_model(byte_vals, s, b):
    """Per byte (uint8 array) and its column's bf16 scale (float32 values
    that are bf16) and bias: the kernel's (lo, hi) weights as bf16 bits.
    Each bf16x2 step rounds once: bf16 - bf16 of small integers is exact,
    bf16 x bf16 is exact in float32 and rounds there once, as does bf16 +
    bf16 (an exact float32 sum whenever it could reach a rounding
    boundary)."""
    words = np.asarray(byte_vals, np.uint32)        # one byte a word, in byte 0
    pair = magic_pairs(words)[0]
    out = []
    for half in (pair & 0xFFFF, pair >> 16):
        v = _bits_to_f32(half) - np.float32(136.0)
        v = _bits_to_f32(_bf16_bits(v)) * s
        v = _bits_to_f32(_bf16_bits(v))
        if b is not None:
            v = _bits_to_f32(_bf16_bits(v + b))
        out.append(_bf16_bits(v))
    return out


# the loaders' bf16 scales run from f16's smallest subnormal (2^-24, Q4_0's
# d) and below (products of two scales) up to large values, of both signs
SCALES = np.array([2.0 ** -24, -2.0 ** -24, 2.0 ** -130, 3.0 * 2.0 ** -133, 1e-30,
                   0.0078125, -0.0123, 0.02, 1.0, 3.3e4, -65504.0, 1.5e30], np.float32)


@pytest.mark.parametrize("bias", [False, True])
def test_magic_unpack_is_the_plain_dequant_bit_for_bit(bias):
    """Every byte value against every scale: the in-register unpack gives
    the bits of ``_dequant4_bf16`` (the plain version's weights)."""
    sb = _bits_to_f32(_bf16_bits(SCALES))          # the bf16 values
    bytes_ = np.arange(256, dtype=np.uint8)
    packed = np.repeat(bytes_[None, :], 1, 0)        # (1, 256): K = 2
    for s in sb:
        b = None
        if bias:
            b = _bits_to_f32(_bf16_bits(np.float32(s) * np.float32(-0.37) + np.float32(1e-3)))
        lo, hi = unpack_model(bytes_, np.float32(s), None if b is None else np.float32(b))
        ref = TQM._dequant4_bf16(torch.from_numpy(packed),
                                 torch.full((1, 256), float(s)).to(torch.bfloat16),
                                 None if b is None else
                                 torch.full((1, 256), float(b)).to(torch.bfloat16),
                                 2, None)
        ref_bits = ref.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(lo, ref_bits[0])
        np.testing.assert_array_equal(hi, ref_bits[1])


def test_magic_pairs_of_four_bytes():
    """The byte permutes pick byte b's nibbles for pair b, lower K row in
    the lower half."""
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    pairs = magic_pairs(w)
    for b in range(4):
        byte = (w >> (8 * b)) & 0xFF
        np.testing.assert_array_equal(pairs[b] & 0xFFFF, 0x4300 | (byte & 0xF))
        np.testing.assert_array_equal(pairs[b] >> 16, 0x4300 | (byte >> 4))
        np.testing.assert_array_equal(_bits_to_f32(pairs[b] & 0xFFFF), 128.0 + (byte & 0xF))


# ------------------------------------------------------- on the card --
CARD_CASES = [(m, k, n, group, lut, bias)
              for m in (1, 8, 16)
              for k, n, group, lut, bias in ((4096, 1024, 32, None, False),
                                             (1024, 4000, 32, IQ4NL, True),
                                             (1024, 1000, 64, None, True),
                                             (512, 256, 16, IQ4NL, False),
                                             (192, 136, 48, None, False))]


@needs_cuda
@pytest.mark.parametrize("m,k,n,group,lut,bias", CARD_CASES)
def test_gemv_kernel_matches_plain(m, k, n, group, lut, bias):
    """M <= 16 runs the GEMV kernel: a codebook, a bias, groups 16-64, a
    ragged N (4000: a partial tile; 1000 and 136: rows not 16-byte aligned,
    the byte-load form)."""
    assert TQM.gemv4_plan(m, n, k, group)["kernel"] == "gemv"
    x, packed, scale, b = _operands(m, k, n, group, lut, bias, seed=m * k + n)
    args = [torch.from_numpy(x).cuda(), torch.from_numpy(packed).cuda(), _bf16(scale).cuda(),
            None if b is None else _bf16(b).cuda()]
    got = TQM.qmatmul4(*args, group=group, lut16=lut)
    ref = TQM.qmatmul4_ref(*args, group=group, lut16=lut)
    w = TQM._dequant4_bf16(*args[1:], group, lut).float()
    absdot = float((args[0].to(torch.bfloat16).float().abs() @ w.abs()).max())
    assert float((got - ref).abs().max()) <= 16 * k ** 0.5 * 2.0 ** -24 * absdot


@needs_cuda
@pytest.mark.parametrize("lut,bias", [(None, False), (None, True), (IQ4NL, True)])
def test_gemv_kernel_weights_are_the_plain_bits(lut, bias):
    """One-hot rows of x read single rows of W: out[m] = W[k_m] exactly
    (one product by 1.0, the rest zeros), for every byte value and scales
    down to 2^-130."""
    k, n, group = 512, 256, 32
    rng = np.random.default_rng(5)
    packed = np.tile(np.arange(256, dtype=np.uint8), (k // 2, 1))
    scale = SCALES[rng.integers(0, len(SCALES), (k // group, n))]
    b = (scale * np.float32(-0.37)).astype(np.float32) if bias else None
    args = [torch.from_numpy(packed).cuda(), _bf16(scale).cuda(),
            None if b is None else _bf16(b).cuda()]
    w = TQM._dequant4_bf16(*args, group, lut).float()
    for k0 in range(0, k, 16):
        x = torch.zeros((16, k), device="cuda")
        x[torch.arange(16), k0 + torch.arange(16)] = 1.0
        got = TQM.qmatmul4(x, *args, group=group, lut16=lut)
        assert torch.equal(got, w[k0:k0 + 16]), k0


@needs_cuda
@pytest.mark.parametrize("m", [1, 16])
def test_gemv_kernel_repeats_bit_for_bit(m):
    """The K split adds its partial sums in a fixed order: no atomics."""
    x, packed, scale, b = _operands(m, 4096, 4096, 32, None, True, seed=9)
    args = [torch.from_numpy(x).cuda(), torch.from_numpy(packed).cuda(), _bf16(scale).cuda(),
            _bf16(b).cuda()]
    assert TQM.gemv4_plan(m, 4096, 4096, 32)["splits"] > 1
    first = TQM.qmatmul4(*args)
    for _ in range(3):
        assert torch.equal(TQM.qmatmul4(*args), first)
