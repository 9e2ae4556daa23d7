"""Kernels D and 15 at M > 16 (``qmatmul_wgmma_kernel``,
``qmatmul4_wgmma_kernel``, csrc/dq_wgmma.cuh): their launch plan, a model of
how a thread's MMA fragment is read from the swizzled code tile, and a
model of their order of sums, held against the JAX package and the port's
plain versions on the CPU; the kernels against the plain versions on the
card (skipped without one).

Tolerance against the plain versions: ``sum_tol`` (chip_smoke.py phase 3).
Every weight is the plain version's bf16 value; the kernels sum the exact
bf16 products in float32 in another order (the MMA's k16 steps in K
order): 16 sqrt(K) float32 roundings of the largest sum of |x w|."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import qmatmul as JQM
from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import qmatmul as TQM
from ik_llama_cpp_tpu_torch.tools import perf_dequant as TP

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

# (k, n) of every kernel-D / kernel-15 launch at M > 16 on the dense 8B
# (fused qkv, wo, fused gate/up, down, the head) and of Qwen1.5-MoE-A2.7B's
# planar K = 1408
MODEL_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000),
                (1408, 2048)]
RAGGED = [(4096, 4000), (256, 96), (1408, 2000)]
ROWS = [17, 40, 100, 128, 512, 513]
IQ4NL = (-127.0, -104.0, -83.0, -65.0, -49.0, -35.0, -22.0, -10.0, 1.0, 13.0, 25.0, 38.0,
         53.0, 69.0, 89.0, 113.0)


def sum_tol(k, absdot):
    return 16 * k ** 0.5 * 2.0 ** -24 * absdot


# ------------------------------------------------------------- the plan --
def tiles_of(plan, block):
    """The (token, column) origins of the output tiles that persistent
    block ``block`` computes, in its order: tile i at tokens (i % m_tiles)
    * tm and columns (i // m_tiles) * tn."""
    mt = plan["m_tiles"]
    return [((i % mt) * plan["tm"], (i // mt) * plan["tn"])
            for i in range(block, plan["tiles"], plan["blocks"])]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", MODEL_SHAPES + RAGGED)
def test_tiled_plan_covers_every_tile_once(k, n, m):
    """The blocks' walks cover the (M, N) output exactly once, with the
    plan's grid and with smaller ones; each tile takes all of K."""
    plan = TQM.tiled_plan(m, n, k, 32)
    assert plan["kernel"] == "wgmma" and plan["tn"] == TQM.TILED_TN
    assert plan["tm"] in TQM.TILED_TILE_COST
    assert plan["m_tiles"] * plan["tm"] >= m > (plan["m_tiles"] - 1) * plan["tm"]
    assert plan["n_tiles"] * plan["tn"] >= n > (plan["n_tiles"] - 1) * plan["tn"]
    assert plan["tiles"] == plan["m_tiles"] * plan["n_tiles"]
    assert 1 <= plan["blocks"] == min(plan["tiles"], _cuda.DEFAULT_SMS)
    assert not any("split" in key for key in plan)
    for blocks in {plan["blocks"], 1, max(1, plan["blocks"] // 3)}:
        seen = np.zeros((plan["m_tiles"], plan["n_tiles"]), np.int64)
        for b in range(blocks):
            for r, c in tiles_of(dict(plan, blocks=blocks), b):
                seen[r // plan["tm"], c // plan["tn"]] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("k,n", MODEL_SHAPES)
def test_tiled_plan_fills_the_card(k, n):
    """At the 512-token prefill chunk every model shape gives at least 70%
    of the SMs a tile (N 6144: 96 tiles of 256 tokens, one round, against
    192 tiles of 128 in two), and no block walks more than one tile beyond
    another."""
    plan = TQM.tiled_plan(512, n, k, 32)
    assert plan["blocks"] >= 0.7 * _cuda.DEFAULT_SMS
    counts = [len(tiles_of(plan, b)) for b in range(plan["blocks"])]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("m,n,tm", [(512, 28672, 256), (512, 32000, 256), (512, 6144, 256),
                                    (512, 4096, 128), (17, 4096, 64), (64, 28672, 64),
                                    (100, 4096, 64)])
def test_tiled_plan_picks_the_width_of_fewest_rounds(m, n, tm):
    """At 132 SMs: 256 tokens where the tiles fill most of their rounds
    (N 28672: 448 tiles, 4 rounds against 7 of 128), 128 where 256 would
    leave half the card idle (N 4096: 128 tiles of 128, 64 of 256), 64 at
    a short chunk (one token tile either way)."""
    assert TQM.tiled_plan(m, n, 4096, 32)["tm"] == tm


@pytest.mark.parametrize("n,k,group", [(1000, 4096, 32), (72, 160, 32), (4096, 4096, 8),
                                       (4096, 4104, 24), (4096, 4032, 96), (4096, 4096, 48)])
def test_tiled_plan_routes_the_rest_to_the_mma_sync_kernel(n, k, group):
    """N not a multiple of 16 (code rows TMA cannot address) and groups
    that are not a multiple of 16 dividing 64 or divided by it take the
    first port's tiled kernels, by name, before the launch."""
    assert TQM.tiled_plan(512, n, k, group) == {"kernel": "tiled"}


@pytest.mark.parametrize("group", [16, 32, 64, 128, 256])
def test_tiled_plan_takes_the_groups_of_whole_stage_rows(group):
    assert TQM.tiled_plan(40, 4096, 4096, group)["kernel"] == "wgmma"


@pytest.mark.parametrize("m", [1, 16])
def test_tiled_plan_refuses_what_the_kernel_does_not_take(m):
    with pytest.raises(ValueError, match="M > 16"):
        TQM.tiled_plan(m, 4096, 4096, 32)


@pytest.mark.parametrize("m,group,want", [(1, 32, "gemv"), (16, 32, "gemv"), (16, 8, "tiled"),
                                          (17, 32, "wgmma"), (512, 8, "tiled")])
def test_kernel_15_routes_each_shape(m, group, want):
    """Kernel 15's three kernels, chosen before the launch: the GEMV at
    M <= 16 where gemv4_plan takes the shape, the wgmma kernel above 16 rows
    where tiled_plan does, the mma.sync kernel for the rest."""
    plan = TQM.gemv4_plan(m, 4096, 4096, group)
    if plan["kernel"] == "tiled" and m > 16:
        plan = TQM.tiled_plan(m, 4096, 4096, group)
    assert plan["kernel"] == want


# ------------------------------------- the fragments, from the code tile --
def swizzled(tile):
    """A (rows, 128) byte tile as TMA's SWIZZLE_128B writes it: 16-byte
    chunk c of row r at chunk c ^ (r % 8)."""
    out = np.zeros_like(tile)
    for r in range(tile.shape[0]):
        for c in range(8):
            d = c ^ (r & 7)
            out[r, 16 * d:16 * d + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def ldmatrix_x4_trans(smem, rows_of_lane, chunk):
    """ldmatrix.x4.trans of b16 elements: lane L gives the 16-byte row
    (rows_of_lane[L], chunk ^ (row % 8)) of matrix L // 8; lane (g, t) gets,
    of each matrix i, b16 element g of its rows 2t and 2t + 1, as the four
    bytes [row 2t: byte 2g, 2g+1; row 2t+1: byte 2g, 2g+1]."""
    rows = [smem[r, 16 * (chunk ^ (r & 7)):16 * (chunk ^ (r & 7)) + 16] for r in rows_of_lane]
    regs = np.zeros((32, 4, 4), np.uint8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            a, b = rows[8 * i + 2 * t], rows[8 * i + 2 * t + 1]
            regs[lane, i] = [a[2 * g], a[2 * g + 1], b[2 * g], b[2 * g + 1]]
    return regs


def planar_fragments(codes_tile, chunk):
    """kernel D's fragments of a 64-row stage for the warp of ``chunk``:
    [step j][lane][register][half], as PlanarCodes::load and ::step build
    them (before the scale)."""
    smem = swizzled(codes_tile.view(np.uint8))
    regs = np.concatenate([ldmatrix_x4_trans(smem, [32 * h + lane for lane in range(32)], chunk)
                           for h in range(2)], axis=1).view(np.int8)     # (32 lanes, 8, 4)
    frag = np.zeros((4, 32, 4, 2), np.int64)
    for j in range(4):
        lo, hi = regs[:, 2 * j], regs[:, 2 * j + 1]
        frag[j, :, 0] = lo[:, [0, 2]]
        frag[j, :, 1] = lo[:, [1, 3]]
        frag[j, :, 2] = hi[:, [0, 2]]
        frag[j, :, 3] = hi[:, [1, 3]]
    return frag


def packed_fragments(packed_tile, chunk):
    """kernel 15's fragments of a 32-packed-row stage: one ldmatrix whose
    matrix rows are packed rows 0, 4, 1, 5, 2, 6, 3, 7 of each step;
    fragment register b is byte b of the step's register, its nibbles the
    two halves."""
    order = [8 * (lane >> 3) + ((lane & 7) >> 1) + 4 * (lane & 1) for lane in range(32)]
    regs = ldmatrix_x4_trans(swizzled(packed_tile), order, chunk)        # (32, 4 steps, 4 bytes)
    frag = np.zeros((4, 32, 4, 2), np.int64)
    for j in range(4):
        for b in range(4):
            frag[j, :, b, 0] = regs[:, j, b] & 0x0F
            frag[j, :, b, 1] = regs[:, j, b] >> 4
    return frag


def expected_fragments(w, chunk):
    """The wgmma A fragment of W^T for the warp of ``chunk``: A rows g and
    g + 8 are columns 16 chunk + 2g and + 1; registers 0/1 at k 2t, 2t+1 of
    the step, 2/3 at k 2t+8, 2t+9 (the lower k in the lower half)."""
    frag = np.zeros((4, 32, 4, 2), np.int64)
    for j in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            col = 16 * chunk + 2 * g
            for r in range(4):
                k = 16 * j + 2 * t + 8 * (r >> 1)
                frag[j, lane, r] = w[k:k + 2, col + (r & 1)]
    return frag


@pytest.mark.parametrize("chunk", range(8))
def test_planar_fragments_are_the_mma_operand(chunk):
    codes = np.random.default_rng(chunk).integers(-128, 128, (64, 128), dtype=np.int8)
    np.testing.assert_array_equal(planar_fragments(codes, chunk),
                                  expected_fragments(codes.astype(np.int64), chunk))


@pytest.mark.parametrize("chunk", range(8))
def test_packed_fragments_are_the_mma_operand(chunk):
    packed = np.random.default_rng(chunk).integers(0, 256, (32, 128), dtype=np.uint8)
    idx = TQM.unpack_int4(torch.from_numpy(packed)).numpy()             # (64, 128)
    np.testing.assert_array_equal(packed_fragments(packed, chunk), expected_fragments(idx, chunk))


# ------------------------------------------------ the order of its sums --
def kernel_model(x, w):
    """The kernels' sums on the CPU: every output tile of the blocks' walks
    starts from zero and adds, k16 step by k16 step in K order, the step's
    exact bf16 products summed in float32; rows and columns past M and N
    read as zeros and are not stored. x (M, K) and w (K, N) hold bf16
    values in float32."""
    m, k = x.shape
    n = w.shape[1]
    plan = TQM.tiled_plan(m, n, k, 32)
    out = np.full((m, n), np.nan, np.float32)
    for blk in range(plan["blocks"]):
        for r0, c0 in tiles_of(plan, blk):
            rows, cols = slice(r0, min(r0 + plan["tm"], m)), slice(c0, min(c0 + plan["tn"], n))
            acc = np.zeros((rows.stop - r0, cols.stop - c0), np.float32)
            for k0 in range(0, k, 16):
                acc = acc + (x[rows, k0:k0 + 16].astype(np.float64)
                             @ w[k0:k0 + 16, cols].astype(np.float64)).astype(np.float32)
            out[rows, cols] = acc
    return out


def _planar_operands(m, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    codes = rng.integers(-128, 128, (k, n), dtype=np.int8)
    scale = rng.uniform(0.002, 0.02, (k // 32, n)).astype(np.float32)
    b = (rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32) if bias else None
    return x, codes, scale, b


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,bias", [(17, 256, 96, False), (40, 192, 160, True),
                                        (130, 128, 144, False)])
def test_planar_kernel_model_matches_jax_and_plain(m, k, n, bias):
    """The model on D's bf16 weights against the JAX oracle and the port's
    plain version."""
    x, codes, scale, b = _planar_operands(m, k, n, bias, seed=m + k)
    w = TQM._dequant_bf16(torch.from_numpy(codes), _bf16(scale),
                          None if b is None else _bf16(b), 32).float().numpy()
    xb = _bf16(x).float().numpy()
    got = kernel_model(xb, w)
    assert np.isfinite(got).all()
    ref_t = TQM.qmatmul_ref(_bf16(x), torch.from_numpy(codes), _bf16(scale),
                            None if b is None else _bf16(b)).numpy()
    ref_j = np.asarray(JQM.qmatmul_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                                       None if b is None else jnp.asarray(b)))
    tol = sum_tol(k, float((np.abs(xb) @ np.abs(w)).max()))
    for ref in (ref_t, ref_j):
        assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("m,k,n,lut", [(17, 256, 96, None), (40, 192, 160, IQ4NL)])
def test_packed_kernel_model_matches_jax_and_plain(m, k, n, lut):
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    scale = rng.uniform(0.0005, 0.002, (k // 32, n)).astype(np.float32)
    w = TQM._dequant4_bf16(torch.from_numpy(packed), _bf16(scale), None, 32, lut).float().numpy()
    xb = _bf16(x).float().numpy()
    got = kernel_model(xb, w)
    ref_t = TQM.qmatmul4_ref(_bf16(x), torch.from_numpy(packed), _bf16(scale), lut16=lut).numpy()
    ref_j = np.asarray(JQM.qmatmul4_ref(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(scale, jnp.bfloat16), lut16=lut))
    tol = sum_tol(k, float((np.abs(xb) @ np.abs(w)).max()))
    for ref in (ref_t, ref_j):
        assert float(np.abs(got - ref).max()) <= tol


# ------------------------------------------------------- on the card --
def _check(got, ref, x, w, k):
    tol = sum_tol(k, float((x.float().abs() @ w.float().abs()).max()))
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= tol


@needs_cuda
@pytest.mark.parametrize("n", [1000, 4000])
@pytest.mark.parametrize("k", [1408, 4096, 14336])
@pytest.mark.parametrize("m", [17, 40, 100, 512, 513])
def test_qmatmul_tiled_kernel_matches_plain(m, k, n):
    """Kernel D above 16 rows: a partial token tile (17, 40, 100, 513), K
    1408 (22 stages of 64), a partial column tile (N 4000) and N 1000 (the
    mma.sync kernel, by the plan); two calls bit for bit."""
    x, codes, scale, _ = _planar_operands(m, k, n, False, seed=m * k + n)
    args = (_bf16(x).cuda(), torch.from_numpy(codes).cuda(), _bf16(scale).cuda())
    got = TQM.qmatmul(*args)
    _check(got, TQM.qmatmul_ref(*args), args[0], TQM._dequant_bf16(args[1], args[2], None, 32), k)
    assert torch.equal(TQM.qmatmul(*args), got)


@needs_cuda
@pytest.mark.parametrize("k,n", MODEL_SHAPES)
@pytest.mark.parametrize("sdt,bias", [(torch.bfloat16, False), (torch.float32, True)])
def test_qmatmul_tiled_kernel_at_model_shapes(k, n, sdt, bias):
    """The 512-token chunk at the model widths, with bf16 and f32 scales
    and a bias."""
    x, codes, scale, b = _planar_operands(512, k, n, bias, seed=k + n)
    args = (_bf16(x).cuda(), torch.from_numpy(codes).cuda(), torch.from_numpy(scale).to(sdt).cuda(),
            None if b is None else torch.from_numpy(b).to(sdt).cuda())
    assert TQM.tiled_plan(512, n, k, 32)["kernel"] == "wgmma"
    got = TQM.qmatmul(*args)
    _check(got, TQM.qmatmul_ref(*args), args[0], TQM._dequant_bf16(*args[1:], 32), k)
    assert torch.equal(TQM.qmatmul(*args), got)


@needs_cuda
@pytest.mark.parametrize("m", [17, 100, 512])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_pair_tiled_kernel_is_the_planar_kernel(m, sdt):
    """The pair form above 16 rows equals kernel D on the unpacked codes bit
    for bit (one plan, one order of sums) and the plain version within
    tolerance."""
    x, codes, scale, _ = _planar_operands(m, 4096, 14336, False, seed=m)
    xc, sc = _bf16(x).cuda(), torch.from_numpy(scale).to(sdt).cuda()
    packed = torch.from_numpy(TP.pack_pairs(codes)).cuda()
    got = TP.qmatmul_pair(xc, packed, sc)
    assert torch.equal(got, TQM.qmatmul(xc, torch.from_numpy(codes).cuda(), sc))
    _check(got, TP.qmatmul_pair_ref(xc, packed, sc), xc,
           TQM._dequant_bf16(torch.from_numpy(codes).cuda(), sc, None, 32), 4096)


def _packed_operands(m, k, n, bias, seed, lut):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, k)).astype(np.float32)).cuda()
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8)).cuda()
    top = 0.002 if lut is not None else 0.02
    scale = _bf16(rng.uniform(top / 4, top, (k // 32, n)).astype(np.float32)).cuda()
    b = _bf16((rng.standard_normal((k // 32, n)) * 0.01).astype(np.float32)).cuda() if bias else None
    return x, packed, scale, b


@needs_cuda
@pytest.mark.parametrize("n", [1000, 4000])
@pytest.mark.parametrize("k", [1408, 4096, 14336])
@pytest.mark.parametrize("m", [17, 40, 100, 512, 513])
@pytest.mark.parametrize("lut", [None, IQ4NL])
def test_qmatmul4_tiled_kernel_matches_plain(m, k, n, lut):
    x, packed, scale, _ = _packed_operands(m, k, n, False, m * k + n, lut)
    got = TQM.qmatmul4(x, packed, scale, lut16=lut)
    _check(got, TQM.qmatmul4_ref(x, packed, scale, lut16=lut), x,
           TQM._dequant4_bf16(packed, scale, None, 32, lut), k)
    assert torch.equal(TQM.qmatmul4(x, packed, scale, lut16=lut), got)


@needs_cuda
@pytest.mark.parametrize("k,n", MODEL_SHAPES)
@pytest.mark.parametrize("lut,bias", [(None, False), (IQ4NL, True)])
def test_qmatmul4_tiled_kernel_at_model_shapes(k, n, lut, bias):
    x, packed, scale, b = _packed_operands(512, k, n, bias, k + n, lut)
    assert TQM.tiled_plan(512, n, k, 32)["kernel"] == "wgmma"
    got = TQM.qmatmul4(x, packed, scale, b, lut16=lut)
    _check(got, TQM.qmatmul4_ref(x, packed, scale, b, lut16=lut), x,
           TQM._dequant4_bf16(packed, scale, b, 32, lut), k)
    assert torch.equal(TQM.qmatmul4(x, packed, scale, b, lut16=lut), got)
