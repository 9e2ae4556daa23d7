"""Kernel A at M <= 16 (``qmatmul_i8_gemv_kernel``): its launch plan and a
plain model of its order of sums, held against the JAX package and the
port's plain version on the CPU; the kernel itself against the plain
version on the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import qmatmul as JQM
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQM

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

# (k, n) of every kernel-A launch at M <= 16 on the models the port runs:
# the dense 8B (fused qkv, wo, fused gate/up, down, the head), Qwen3-30B-A3B
# (fused qkv, the head, wo) and Qwen1.5-MoE-A2.7B (fused qkv, q/k/v/wo, the
# shared expert's gate/up and down)
MODEL_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000),
                (2048, 5120), (2048, 151936), (4096, 2048),
                (2048, 6144), (2048, 2048), (2048, 11264), (5632, 2048)]
# a partial column tile, rows that are not a whole tile, one supergroup
RAGGED = [(4096, 4000), (2048, 1000), (256, 1000), (256, 40)]


# ------------------------------------------------------------- the plan --
@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", MODEL_SHAPES + RAGGED)
def test_gemv_i8_plan_covers_every_step_once(k, n, m):
    """The K ranges of a cluster's warps are whole 64-deep steps, in order,
    and cover K exactly once, so every (step, column) is summed once; the
    column tiles cover N."""
    plan = TQM.gemv_i8_plan(m, n, k)
    assert 1 <= plan["splits"] <= TQM.GEMV_MAX_SPLITS
    assert plan["tiles"] * TQM.GEMV_I8_COLS >= n > (plan["tiles"] - 1) * TQM.GEMV_I8_COLS
    assert plan["steps"] * TQM.GEMV_I8_STEP == k
    ranges = TQM.gemv_k_ranges(k, TQM.GEMV_I8_STEP, plan["splits"])
    assert len(ranges) == plan["splits"] * TQM.GEMV_WARPS
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    covered = np.zeros(plan["steps"], np.int64)
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:] + [(k, k)]):
        assert lo % TQM.GEMV_I8_STEP == 0 and hi % TQM.GEMV_I8_STEP == 0 and lo <= hi == lo2
        covered[lo // TQM.GEMV_I8_STEP: hi // TQM.GEMV_I8_STEP] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("k,n", MODEL_SHAPES)
def test_gemv_i8_plan_fills_the_card(k, n):
    """At least ~one block an SM of the H100 (128) at every model shape,
    at most GEMV_I8_BLOCKS where the split is chosen, and every warp at
    least GEMV_I8_MIN_STEPS steps."""
    plan = TQM.gemv_i8_plan(1, n, k)
    blocks = plan["tiles"] * plan["splits"]
    assert blocks >= 128
    assert blocks <= TQM.GEMV_I8_BLOCKS or plan["splits"] == 1
    assert plan["splits"] * TQM.GEMV_WARPS * TQM.GEMV_I8_MIN_STEPS <= plan["steps"]


@pytest.mark.parametrize("m,k", [(17, 4096), (0, 4096), (512, 4096), (1, 4000), (16, 128),
                                 (1, 0)])
def test_gemv_i8_plan_refuses_what_the_kernel_does_not_take(m, k):
    with pytest.raises(ValueError, match="M <= 16 kernel"):
        TQM.gemv_i8_plan(m, 4096, k)


# ------------------------------------------------ the order of its sums --
def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (k, n), dtype=np.int8)
    scale = (rng.random((k // 32, n), dtype=np.float32) * 0.1).astype(np.float32)
    q8, sw = TQM.requant_supergroup(codes, scale)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 4, (m, 1))).astype(np.float32)
    xq, xs = TQM.quantize_activations(torch.from_numpy(x))
    return xq.numpy(), xs.numpy(), q8, sw


def kernel_model(xq, xs, q8, sw):
    """The M <= 16 kernel's arithmetic on the CPU: each warp of the cluster
    takes its range of 64-deep steps; inside it, each supergroup's part
    (the whole supergroup or the piece the range holds) is an exact integer
    dot, corrected once by xs[m] * sw[n] into the warp's float sum; a block
    adds its 4 warps' sums in order, then the blocks are added in rank
    order."""
    m, k = xq.shape
    n = q8.shape[1]
    plan = TQM.gemv_i8_plan(m, n, k)
    sg = TQM.SUPERGROUP
    parts = []
    for lo, hi in TQM.gemv_k_ranges(k, TQM.GEMV_I8_STEP, plan["splits"]):
        acc = np.zeros((m, n), np.float32)
        for a in range(lo, hi):
            if a % sg and a != lo:
                continue
            b = min(hi, (a // sg + 1) * sg)
            dot = xq[:, a:b].astype(np.int64) @ q8[a:b].astype(np.int64)
            corr = xs[:, a // sg][:, None] * sw[a // sg][None, :]
            acc = acc + dot.astype(np.float32) * corr
        parts.append(acc)
    total = None
    for r in range(plan["splits"]):
        blk = parts[4 * r]
        for i in range(1, TQM.GEMV_WARPS):
            blk = blk + parts[4 * r + i]
        total = blk if total is None else total + blk
    return total, plan


@pytest.mark.parametrize("m,k,n", [(1, 2048, 96), (5, 4096, 64), (16, 2048, 40),
                                   (8, 5632, 32), (3, 1280, 72)])
def test_kernel_model_matches_jax_and_plain(m, k, n):
    """The model, with a K split that cuts supergroups between warps (K
    2048, 1280) and between blocks, against the JAX oracle and the port's
    plain version: corrections of the parts of a supergroup add up to the
    supergroup's correction within float32 rounding."""
    xq, xs, q8, sw = _operands(m, k, n, seed=m * 7 + k)
    got, plan = kernel_model(xq, xs, q8, sw)
    ranges = TQM.gemv_k_ranges(k, TQM.GEMV_I8_STEP, plan["splits"])
    if k in (2048, 1280):
        assert any(lo % TQM.SUPERGROUP for lo, _ in ranges), "no supergroup is cut"
    ref_j = np.asarray(JQM.qmatmul_i8_ref(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(q8),
                                          jnp.asarray(sw)))
    ref_t = TQM.qmatmul_i8_ref(torch.from_numpy(xq), torch.from_numpy(xs),
                               torch.from_numpy(q8), torch.from_numpy(sw)).numpy()
    for ref in (ref_j, ref_t):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max() + 1e-6)


# ------------------------------------------------------- on the card --
def _card(m, k, n, seed):
    xq, xs, q8, sw = _operands(m, k, n, seed)
    codes = torch.from_numpy(np.ascontiguousarray(q8.T)).cuda().t()
    return (torch.from_numpy(xq).cuda(), torch.from_numpy(xs).cuda(), codes,
            torch.from_numpy(sw).cuda())


@needs_cuda
@pytest.mark.parametrize("n", [1000, 4000, 2048])
@pytest.mark.parametrize("k", [256, 2048, 4096, 5632])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 16, 17])
def test_gemv_i8_kernel_matches_plain(m, k, n):
    """M <= 16 runs the GEMV kernel (M 17 the tiled one), against the plain
    version within phase 3's tolerance: a partial column tile (1000, 4000),
    one supergroup (K 256), supergroups cut between warps (K 2048, 5632)."""
    args = _card(m, k, n, seed=m * k + n)
    got = TQM.qmatmul_i8(*args)
    ref = TQM.qmatmul_i8_ref(*args)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6


@needs_cuda
@pytest.mark.parametrize("m", [1, 16])
def test_gemv_i8_kernel_repeats_bit_for_bit(m):
    """The K split adds its partial sums in a fixed order: no atomics."""
    args = _card(m, 4096, 4096, seed=9)
    assert TQM.gemv_i8_plan(m, 4096, 4096)["splits"] > 1
    first = TQM.qmatmul_i8(*args)
    for _ in range(3):
        assert torch.equal(TQM.qmatmul_i8(*args), first)
