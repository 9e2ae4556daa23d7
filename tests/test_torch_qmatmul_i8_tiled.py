"""Kernel A at M > 16 (``qmatmul_i8_wgmma_kernel``): its launch plan and a
plain model of its order of sums, held against the JAX package and the
port's plain version on the CPU; the kernel itself against the plain
version on the card (skipped without one).

Tolerance against the plain versions: 1e-5 max|ref| + 1e-6, phase 3's. Each
supergroup's integer dot is exact on every side; the float corrections
(xs * sw per supergroup, summed over K / 256 supergroups) are rounded in
another order by the plain versions ((dot * xs) * sw, then the sum), a few
float32 roundings of the largest output."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import qmatmul as JQM
from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQM

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

# (k, n) of every kernel-A launch at M > 16 on the models the port runs:
# the dense 8B (fused qkv, wo, fused gate/up, down, the head), Qwen3-30B-A3B
# (fused qkv, the head, wo) and Qwen1.5-MoE-A2.7B (fused qkv, q/k/v/wo, the
# shared expert's gate/up and down)
MODEL_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000),
                (2048, 5120), (2048, 151936), (4096, 2048),
                (2048, 6144), (2048, 2048), (2048, 11264), (5632, 2048)]
RAGGED = [(4096, 4000), (2048, 1000), (256, 1000), (256, 40)]
ROWS = [17, 40, 100, 128, 512, 513]


# ------------------------------------------------------------- the plan --
def tiled_i8_tiles(plan, block):
    """The (row, column) origins of the output tiles that persistent block
    ``block`` computes, in its order: the kernel's walk, tile i at rows
    (i % m_tiles) * bm and columns (i // m_tiles) * bn."""
    mt = plan["m_tiles"]
    return [((i % mt) * plan["bm"], (i // mt) * plan["bn"])
            for i in range(block, plan["tiles"], plan["blocks"])]


def _covered(plan, blocks):
    """How many times each output tile is computed by ``blocks`` blocks."""
    seen = np.zeros((plan["m_tiles"], plan["n_tiles"]), np.int64)
    for blk in range(blocks):
        for r, c in tiled_i8_tiles(dict(plan, blocks=blocks), blk):
            assert r % plan["bm"] == 0 and c % plan["bn"] == 0
            seen[r // plan["bm"], c // plan["bn"]] += 1
    return seen


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", MODEL_SHAPES + RAGGED)
def test_tiled_i8_plan_covers_every_tile_once(k, n, m):
    """The blocks' tile walks cover the (M, N) output exactly once, tile
    origins on the tile grid, with the plan's grid (every block a tile) and
    with smaller ones; each tile takes all of K (the plan has no K split)."""
    plan = TQM.tiled_i8_plan(m, n, k)
    assert plan["bm"] == TQM.TILED_I8_BM and plan["bn"] in TQM.TILED_I8_TILE_COST
    assert plan["m_tiles"] * plan["bm"] >= m > (plan["m_tiles"] - 1) * plan["bm"]
    assert plan["n_tiles"] * plan["bn"] >= n > (plan["n_tiles"] - 1) * plan["bn"]
    assert plan["tiles"] == plan["m_tiles"] * plan["n_tiles"]
    assert 1 <= plan["blocks"] == min(plan["tiles"], _cuda.DEFAULT_SMS)
    assert not any("split" in key for key in plan)
    assert all(tiled_i8_tiles(plan, b) for b in range(plan["blocks"]))
    for blocks in {plan["blocks"], 1, max(1, plan["blocks"] // 3)}:
        assert (_covered(plan, blocks) == 1).all()


@pytest.mark.parametrize("k,n", MODEL_SHAPES)
def test_tiled_i8_plan_fills_the_card(k, n):
    """At the 512-token prefill chunk every model shape gives at least 80%
    of the SMs a tile, and a block that walks several tiles never gets more
    than one tile beyond any other block."""
    plan = TQM.tiled_i8_plan(512, n, k)
    assert plan["blocks"] >= 0.8 * _cuda.DEFAULT_SMS
    counts = [len(tiled_i8_tiles(plan, b)) for b in range(plan["blocks"])]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("n,bn", [(4096, 128), (28672, 128), (32000, 128), (11264, 192),
                                  (151936, 192), (6144, 192), (5120, 192), (2048, 64)])
def test_tiled_i8_plan_picks_the_width_of_fewest_rounds(n, bn):
    """At M 512 on 132 SMs: 128 columns where the tiles fill whole rounds
    (N 4096: 128 tiles) or most of the last one (28672: 896 tiles, 6.8
    rounds), 192 where 128 would leave most of a last round idle (6144:
    192 tiles, 192 columns give 128; 11264: 352 against 236), 64 where 128
    would leave half the card idle (2048: 64 tiles)."""
    assert TQM.tiled_i8_plan(512, n, 4096)["bn"] == bn
    assert TQM.tiled_i8_plan(512, 2048, 4096, sms=64)["bn"] == 128


@pytest.mark.parametrize("m,k,n", [(16, 4096, 4096), (1, 4096, 4096), (17, 4000, 4096),
                                   (512, 128, 4096), (512, 4096, 0), (512, 0, 4096)])
def test_tiled_i8_plan_refuses_what_the_kernel_does_not_take(m, k, n):
    with pytest.raises(ValueError, match="M > 16 kernel"):
        TQM.tiled_i8_plan(m, n, k)


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
    """The M > 16 kernel's arithmetic on the CPU: every output tile of the
    blocks' walks starts from zero and adds, supergroup by supergroup in order, the
    exact integer dot times (xs[m] * sw[n]) in float32; rows and columns
    past M and N read as zero codes and are not stored."""
    m, k = xq.shape
    n = q8.shape[1]
    plan = TQM.tiled_i8_plan(m, n, k)
    sg = TQM.SUPERGROUP
    out = np.full((m, n), np.nan, np.float32)
    for blk in range(plan["blocks"]):
        for r0, c0 in tiled_i8_tiles(plan, blk):
            rows, cols = slice(r0, min(r0 + plan["bm"], m)), slice(c0, min(c0 + plan["bn"], n))
            acc = np.zeros((rows.stop - r0, cols.stop - c0), np.float32)
            for g in range(k // sg):
                ks = slice(g * sg, (g + 1) * sg)
                dot = xq[rows, ks].astype(np.int64) @ q8[ks, cols].astype(np.int64)
                corr = xs[rows, g][:, None] * sw[g, cols][None, :]
                acc = acc + dot.astype(np.float32) * corr
            out[rows, cols] = acc
    return out


@pytest.mark.parametrize("m,k,n", [(17, 512, 96), (40, 256, 200), (130, 768, 72),
                                   (100, 1024, 130)])
def test_kernel_model_matches_jax_and_plain(m, k, n):
    """The model (every element written once, ragged rows and columns)
    against the JAX oracle and the port's plain version."""
    xq, xs, q8, sw = _operands(m, k, n, seed=m * 3 + k)
    got = kernel_model(xq, xs, q8, sw)
    assert np.isfinite(got).all()
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
@pytest.mark.parametrize("n", [1000, 4000])
@pytest.mark.parametrize("k", [256, 2048, 4096, 14336])
@pytest.mark.parametrize("m", [17, 40, 100, 512, 513])
def test_tiled_i8_kernel_matches_plain(m, k, n):
    """The tiled kernel against the plain version: one supergroup (K 256)
    to 56 (K 14336), a partial row tile (17, 40, 100, 513), a partial
    column tile of each width (N 1000 takes 64 columns; N 4000 64 up to M
    100, 128 at M 512, 192 at M 513), and the call repeats bit for bit."""
    args = _card(m, k, n, seed=m * k + n)
    got = TQM.qmatmul_i8(*args)
    ref = TQM.qmatmul_i8_ref(*args)
    assert got.shape == (m, n)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
    assert torch.equal(TQM.qmatmul_i8(*args), got)


@needs_cuda
@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 28672), (14336, 4096), (2048, 2048),
                                 (2048, 5120)])
def test_tiled_i8_kernel_at_model_shapes(k, n):
    """The 512-token prefill chunk at model shapes (64-, 128- and
    192-column tiles, grids of one and of several tiles a block)."""
    args = _card(512, k, n, seed=k + n)
    got = TQM.qmatmul_i8(*args)
    ref = TQM.qmatmul_i8_ref(*args)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
    assert torch.equal(TQM.qmatmul_i8(*args), got)
