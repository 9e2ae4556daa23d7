"""Kernel 14's warpgroup-MMA form (``csrc/moe_qmm.cu``,
ragged_wgmma_kernel): its plan, its work-item map, a CPU model of its
K-major code fragments and of its order of sums against the JAX package,
and the kernel against its plain version on the card (skipped without
one).

The kernel computes what ``ragged_qmatmul_ref`` does: w = bf16(bf16(code)
* bf16(scale)) and float32 sums of exact bf16 x bf16 products, only in
another order (the MMA's k16 steps in K order). The CPU model at small K:
rtol 1e-5, atol 1e-4, the tolerance of tests/test_torch_moe_planar.py; the
card cases up to K 2048 with weights up to 127 x 0.06: ``sum_tol``
(chip_smoke.py phase 3), 16 sqrt(K) float32 roundings of the largest sum
of |x w| over the live rows."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe_qmm as JQ
from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import moe_qmm as TQ
from ik_llama_cpp_tpu_torch.ops.moe_decode import dequant_experts

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")
SMS = _cuda.DEFAULT_SMS


def sizes(kind, m, g, seed=0):
    """Group sizes: random (multinomial), skewed (harmonic, shuffled), zero,
    one expert, some experts empty, and a sum past M (the kernel clamps)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.multinomial(m, np.full(g, 1.0 / g))
    if kind == "skewed":
        harm = 1.0 / np.arange(1, g + 1)
        return rng.permutation(rng.multinomial(m, harm / harm.sum()))
    if kind == "zero":
        return np.zeros(g, np.int64)
    if kind == "one":
        out = np.zeros(g, np.int64)
        out[g // 2] = m
        return out
    if kind == "sparse":
        out = rng.multinomial(m - m // 3, np.full(g // 3, 3.0 / g))
        return np.concatenate([np.zeros(g - g // 3, np.int64), out])[rng.permutation(g)]
    if kind == "past_m":
        return rng.multinomial(m + 50, np.full(g, 1.0 / g))
    raise ValueError(kind)


# ------------------------------------------------------- the work map --
def ragged_items(plan: dict, group_sizes, m: int) -> list:
    """The sweeps each block of the wgmma form runs, in order: a model of
    the kernel's GroupedItems (csrc/moe_qmm.cu). [block][i] = (u, expert, n0,
    m0, m_end): sweep number u, tokens [m0, m0 + tm) against columns
    [n0, n0 + tn) of the expert, rows below m_end stored. Sweeps are
    numbered over the experts with rows (their rows clamped to M) in
    order, then column tiles, then token tiles; sweep u goes to block
    u % blocks."""
    ends, live, end = [], [], 0
    for e, c in enumerate(int(v) for v in group_sizes):
        start, end = min(end, m), min(end + c, m)
        ends.append(end)
        if end > start:
            live.append(e)
    blocks, u = [[] for _ in range(plan["blocks"])], 0
    for e in live:
        start = ends[e - 1] if e else 0
        for ct in range(plan["n_tiles"]):
            for m0 in range(start, ends[e], plan["tm"]):
                blocks[u % plan["blocks"]].append(
                    (u, e, ct * plan["tn"], m0, min(m0 + plan["tm"], ends[e])))
                u += 1
    return blocks


# ------------------------------------------------------------- the plan --
@pytest.mark.parametrize("m,k,n,g,group,sb", [
    (2048, 1408, 2048, 60, 32, 2),      # Qwen1.5-MoE-A2.7B's down experts (phase 12)
    (4096, 2048, 768, 128, 32, 2),      # Qwen3-30B-A3B all planar (phase 13)
    (1024, 768, 2048, 128, 32, 4),      # its down experts, f32 scales
    (17, 64, 128, 4, 16, 4), (8, 96, 128, 8, 32, 2), (64, 512, 128, 4, 256, 4),
    (40000, 1024, 512, 8, 64, 2), (1, 128, 8, 1, 128, 2)])
def test_plan_takes_tma_shapes(m, k, n, g, group, sb):
    """The wgmma form for every shape TMA addresses: the grid sized from M,
    N and G (the most sweeps a call can have, at most one block an SM);
    sweeps of 64 tokens where the experts average up to 96 rows, else 128;
    no group sizes bring more sweeps than the plan counts."""
    plan = TQ.ragged_plan(m, n, k, g, group, sb, SMS)
    assert plan["kernel"] == "wgmma"
    assert plan["n_tiles"] == -(-n // TQ.RAGGED_TN) and plan["tn"] == TQ.RAGGED_TN
    assert plan["tm"] == (64 if m <= 96 * g else 128)
    assert plan["sweeps"] == plan["n_tiles"] * (-(-m // plan["tm"]) + min(g, m))
    assert plan["blocks"] == min(plan["sweeps"], SMS)
    for kind in ("random", "skewed", "one", "sparse", "past_m"):
        if g >= 3:
            got = ragged_items(plan, sizes(kind, m, g, seed=g), m)
            assert sum(map(len, got)) <= plan["sweeps"]


@pytest.mark.parametrize("n,k,group,sb", [
    (1001, 64, 32, 2),     # bf16 scale rows of 2002 bytes
    (1002, 64, 32, 4),     # f32 scale rows of 4008 bytes
    (128, 96, 48, 2),      # a group that neither divides 64 nor is a multiple of it
    (128, 160, 80, 4), (128, 64, 8, 2)])
def test_plan_routes_the_rest_to_the_mma_sync_kernel(n, k, group, sb):
    assert TQ.ragged_plan(64, n, k, 4, group, sb, SMS) == {"kernel": "ragged"}


def test_plan_at_the_measured_shape():
    """Phase 12's chunk: sweeps of 64 tokens (~34 rows an expert) over 16
    column tiles, one block an SM."""
    plan = TQ.ragged_plan(2048, 2048, 1408, 60, 32, 2, 132)
    assert (plan["tm"], plan["n_tiles"], plan["blocks"]) == (64, 16, 132)


# --------------------------------------------------- the work-item map --
@pytest.mark.parametrize("kind", ["random", "skewed", "zero", "one", "sparse", "past_m"])
@pytest.mark.parametrize("m,n,g,blocks", [(2048, 2048, 60, 132), (300, 768, 16, 7),
                                          (4096, 768, 128, 132), (20, 384, 8, 1)])
def test_items_store_every_live_row_once(kind, m, n, g, blocks):
    """Every live row (below sum(group_sizes) and M) is stored exactly once
    in each column tile, by a sweep of its own expert; the sweeps of each
    (expert, column tile) are consecutive in the order, which the blocks
    take round robin, so they run at once and share the tile's codes;
    every block's sweeps come in rising order; empty experts get no sweep;
    rows past the live ones none."""
    gs = sizes(kind, m, g, seed=m + g)
    plan = dict(TQ.ragged_plan(m, n, 1024, g, 32, 2, SMS), blocks=blocks)
    got = ragged_items(plan, gs, m)
    assert len(got) == blocks
    ends = np.minimum(np.cumsum(gs), m)
    starts = np.concatenate([[0], ends[:-1]])
    owner = np.full(m, -1)
    for e in range(g):
        owner[starts[e]:ends[e]] = e
    stored = np.zeros((m, plan["n_tiles"]), np.int64)
    seen = {}
    for b, sweeps in enumerate(got):
        assert [s[0] for s in sweeps] == list(range(b, b + blocks * len(sweeps), blocks))
        for u, e, n0, m0, m_end in sweeps:
            assert ends[e] > starts[e], "an empty expert got a sweep"
            assert starts[e] <= m0 < m_end <= min(m0 + plan["tm"], ends[e])
            assert (owner[m0:m_end] == e).all()
            stored[m0:m_end, n0 // plan["tn"]] += 1
            seen.setdefault((e, n0), []).append((u, m0))
    live = owner >= 0
    assert (stored[live] == 1).all() and (stored[~live] == 0).all()
    n_live = int((ends > starts).sum())
    assert len(seen) == n_live * plan["n_tiles"]
    for (e, _), us in seen.items():
        us.sort()
        assert [u for u, _ in us] == list(range(us[0][0], us[0][0] + len(us)))
        assert [m0 for _, m0 in us] == list(range(starts[e], ends[e], plan["tm"]))


# ----------------------------------------- the K-major code fragments --
def swizzled_tile(codes_t, n0, k0):
    """A stage's code tile as TMA writes it: 128 columns of 64 code bytes
    (codes_t (N, K), K-contiguous; zero past N and K), 64-byte rows, and the
    64-byte swizzle: address bits 4-5 XOR bits 7-8, so 16-byte chunk c of
    column n lands at chunk c ^ ((n >> 1) & 3)."""
    n, k = codes_t.shape
    box = np.zeros((128, 64), np.uint8)
    rows, cols = min(128, n - n0), min(64, k - k0)
    box[:rows, :cols] = codes_t[n0:n0 + rows, k0:k0 + cols].view(np.uint8)
    flat = box.reshape(-1)
    tile = np.zeros(128 * 64, np.uint8)
    o = np.arange(128 * 64)
    tile[o ^ (((o >> 7) & 3) << 4)] = flat
    return tile


def fragment_loads(tile, lane, chunk):
    """KMajorCodes::load: the thread's 8 registers (4 k16 steps x the pairs at
    k 2t and 2t + 8), each the 16-bit pairs of columns l and l + 1; and the
    byte addresses of its 16 loads by (j, h, column)."""
    g, t = lane >> 2, lane & 3
    p = (16 * chunk + 2 * g) * 64 + 2 * t
    regs, addrs = [], {}
    for j in range(4):
        for h in range(2):
            a0 = p + ((j ^ (g & 3)) << 4) + 8 * h
            a1 = p + 64 + ((j ^ (g & 3)) << 4) + 8 * h
            addrs[(j, h, 0)], addrs[(j, h, 1)] = a0, a1
            regs.append(tile[a0:a0 + 2].tolist() + tile[a1:a1 + 2].tolist())
    return regs, addrs


@pytest.mark.parametrize("n,k,n0,k0", [(256, 128, 0, 0), (256, 128, 128, 64),
                                       (200, 96, 128, 64), (2048, 1408, 1920, 1344)])
def test_k_major_fragments_hold_the_a_operand(n, k, n0, k0):
    """Each thread's registers hold the codes of its wgmma A fragment: for
    warp chunk w (columns 16w ..) and k16 step j, fragment rows g and g + 8
    are columns l = 16w + 2g and l + 1 (the permutation kernel D's store
    undoes), a0 / a1 their codes at k 2t, 2t + 1, a2 / a3 at 2t + 8, 2t + 9,
    the lower k in the lower byte; zeros past N and K."""
    rng = np.random.default_rng(n + k)
    codes_t = rng.integers(-128, 128, (n, k), dtype=np.int8)
    full = np.zeros((max(n, n0 + 128), max(k, k0 + 64)), np.int8)
    full[:n, :k] = codes_t
    tile = swizzled_tile(codes_t, n0, k0)
    for chunk in range(8):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            l = n0 + 16 * chunk + 2 * g
            regs, _ = fragment_loads(tile, lane, chunk)
            for j in range(4):
                for h in range(2):
                    kk = k0 + 16 * j + 2 * t + 8 * h
                    want = [full[l, kk], full[l, kk + 1], full[l + 1, kk], full[l + 1, kk + 1]]
                    got = np.array(regs[2 * j + h], np.uint8).view(np.int8).tolist()
                    assert got == want, (chunk, lane, j, h)


def test_k_major_loads_take_two_wavefronts():
    """Each 16-bit load instruction of a warp touches 16 distinct 4-byte
    words (lanes t = 2i, 2i + 1 share one), two to a bank at most: the
    swizzle spreads the 8 columns of a load over 4 chunks of their lines."""
    tile = np.zeros(128 * 64, np.uint8)
    for chunk in range(8):
        for key in [(j, h, c) for j in range(4) for h in range(2) for c in range(2)]:
            words = {fragment_loads(tile, lane, chunk)[1][key] // 4 for lane in range(32)}
            banks = [w % 32 for w in words]
            assert len(words) == 16 and max(banks.count(b) for b in banks) == 2


# ------------------------------------------------ the order of the sums --
def sweep_model(x, codes, scale, gs, group, tm):
    """The kernel's arithmetic in numpy: per sweep of tm rows of an expert,
    float32 accumulators that add each k16 step's exact products (16 bf16 x
    bf16 terms, summed in float64 and rounded once, as the MMA's
    accumulation does) in K order; rows past the live ones stay NaN."""
    m, k = x.shape
    n = codes.shape[2]
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    out = np.full((m, n), np.nan, np.float32)
    start = 0
    for e, c in enumerate(gs):
        end = min(start + int(c), m)
        w = dequant_experts(torch.from_numpy(codes[e]), torch.from_numpy(scale[e]),
                            group).double().numpy()
        for m0 in range(start, end, tm):
            rows = slice(m0, min(m0 + tm, end))
            acc = np.zeros((rows.stop - rows.start, n), np.float32)
            for k0 in range(0, k, 16):
                acc = (acc + (xb[rows, k0:k0 + 16] @ w[k0:k0 + 16]).astype(np.float32)
                       ).astype(np.float32)
            out[rows] = acc
        start = end
    return out


@pytest.mark.parametrize("m,k,n,g,kind", [(96, 352, 256, 4, "skewed"), (70, 128, 128, 8, "sparse"),
                                          (200, 256, 128, 3, "random")])
def test_sweep_model_matches_jax(m, k, n, g, kind):
    rng = np.random.default_rng(m)
    codes = rng.integers(-127, 128, (g, k, n), dtype=np.int8)
    scale = (rng.standard_normal((g, k // 32, n)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    gs = sizes(kind, m, g, seed=m).astype(np.int32)
    live = int(gs.sum())
    tm = TQ.ragged_plan(m, n, k, g, 32, 4, SMS)["tm"]
    got = sweep_model(x, codes, scale, gs, 32, tm)
    jx = jnp.asarray(torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    ref = np.asarray(JQ.ragged_qmatmul_ref(jx[:live], jnp.asarray(codes), jnp.asarray(scale),
                                           jnp.asarray(gs), group=32))
    np.testing.assert_allclose(got[:live], ref, rtol=1e-5, atol=1e-4)
    assert np.isnan(got[live:]).all()


# ------------------------------------------------------- on the card --
def sum_tol(k, absdot):
    return 16 * k ** 0.5 * 2.0 ** -24 * absdot


def t_codes(codes):
    """Stored (G, N, K), held as the (G, K, N) view, as the loader does."""
    return torch.from_numpy(codes.transpose(0, 2, 1).copy()).cuda().transpose(1, 2)


# M, K, N, G, group, scale dtype, sizes: the two model shapes (phases 12
# and 13), f32 scales, groups 16 to 256, K not a multiple of 64, N not a
# multiple of 128, sweeps of 128 tokens, an expert past 128 rows, empty
# experts, a sum past M, and a shape the plan routes to the mma.sync form
CARD = [(2048, 1408, 2048, 60, 32, torch.bfloat16, "random"),
        (2048, 1408, 2048, 60, 32, torch.bfloat16, "skewed"),
        (2048, 1408, 2048, 60, 32, torch.bfloat16, "zero"),
        (1024, 2048, 768, 128, 32, torch.bfloat16, "skewed"),
        (512, 768, 2048, 128, 32, torch.float32, "sparse"),
        (300, 352, 1000, 5, 32, torch.float32, "random"),
        (600, 512, 256, 4, 256, torch.float32, "skewed"),
        (130, 96, 256, 3, 16, torch.bfloat16, "one"),
        (1500, 1024, 384, 8, 64, torch.bfloat16, "random"),
        (200, 640, 512, 16, 128, torch.float32, "past_m"),
        (17, 128, 128, 60, 32, torch.bfloat16, "random"),
        (100, 96, 1001, 4, 32, torch.bfloat16, "random")]


@needs_cuda
@pytest.mark.parametrize("m,k,n,g,group,sdt,kind", CARD)
def test_grouped_kernel_matches_plain(m, k, n, g, group, sdt, kind):
    """Kernel 14 against its plain version over the live rows, and two
    calls bit for bit; the wgmma form wherever the plan takes the shape."""
    rng = np.random.default_rng(m + n)
    codes = rng.integers(-127, 128, (g, k, n), dtype=np.int8)
    scale = torch.from_numpy((rng.standard_normal((g, k // group, n)) * 0.02)
                             .astype(np.float32)).cuda().to(sdt)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda().to(torch.bfloat16)
    gs = torch.from_numpy(sizes(kind, m, g, seed=m).astype(np.int32)).cuda()
    live = min(int(gs.sum()), m)
    a = (x, t_codes(codes), scale, gs)
    before = TQ.ragged_qmatmul.wgmma_launches
    got = TQ.ragged_qmatmul(*a, group=group)
    wgmma = TQ.ragged_plan(m, n, k, g, group, scale.element_size(),
                           _cuda.sm_count(x))["kernel"] == "wgmma"
    assert TQ.ragged_qmatmul.wgmma_launches - before == int(wgmma)
    assert wgmma == (n != 1001)
    ref = TQ.ragged_qmatmul_ref(*a, group=group)
    if live:
        absdot = TQ.ragged_qmatmul_ref(x.abs(), a[1].abs(), scale.abs(), gs, group=group)
        err = float((got[:live] - ref[:live]).abs().max())
        assert err <= sum_tol(k, float(absdot[:live].max()))
    for _ in range(2):
        assert torch.equal(TQ.ragged_qmatmul(*a, group=group)[:live], got[:live])
