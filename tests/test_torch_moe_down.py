"""The MoE down kernels 8 (``moe_decode_down_i8``) and 13 (``moe_decode_down``):
their launch plan and a plain model of kernel 8's order of sums on the CPU;
the kernels against their plain versions on the card (skipped without one)
at the shapes the tiling can get wrong: top_k 1-8, T 1 and 8 with experts
repeated across pairs and tokens, an E that the column tile does not
divide, kernel 8 at F 256 and 768, kernel 13 at F 352 and 1408 with groups
16 and 32 (group 256 at F 512 and 768, which it divides, and the groups 48
and 96, which are not powers of two), f32 and bf16 scales. Each card case
also checks that two calls repeat bit for bit."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

# (t, top_k, f, e, group): the paths' decode shapes (Qwen3-30B-A3B int8 and
# all-planar, Qwen1.5-MoE-A2.7B planar), top_k 1-8, E off the tile, small F
PLAN_SHAPES = [(1, 8, 768, 2048, None), (8, 8, 768, 2048, None), (1, 1, 256, 204, None),
               (2, 2, 256, 100, None), (3, 3, 512, 77, None), (1, 64, 768, 2048, None),
               (1, 4, 1408, 2048, 32), (8, 4, 1408, 2048, 32), (1, 8, 768, 2048, 32),
               (1, 1, 352, 204, 16), (2, 3, 96, 100, 32), (1, 2, 1408, 200, 16),
               (4, 6, 512, 300, 256), (1, 64, 1408, 2048, 32)]


def lane_chunks(plan, f, tid):
    """The chunks of its row that thread ``tid`` of a block holds: the
    kernels' indexing, chunk lr + lanes * i for i < chunks, within the row."""
    lanes, nch = plan["lanes"], f // 16
    lr = tid % lanes
    return [lr + lanes * i for i in range(plan["chunks"]) if lr + lanes * i < nch]


@pytest.mark.parametrize("t,top_k,f,e,group", PLAN_SHAPES)
def test_down_plan_covers_every_row_once(t, top_k, f, e, group):
    """Every (token, pair, column, chunk) is loaded by exactly one live lane;
    a block holds all of its token's pairs for its columns; the row's lanes
    are an aligned power-of-two group of a warp (the shuffle), and for int8
    a lane's chunks of one supergroup are consecutive (16 / lanes of them)."""
    plan = TD.down_plan(t, top_k, f, e, group)
    cols, lanes, nch = plan["cols"], plan["lanes"], f // 16
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= (16 if group is None else 32)
    assert plan["tiles"] == -(-e // cols) and plan["blocks"] == plan["tiles"] * t
    rows, rpp = top_k * cols, TD.DOWN_THREADS // lanes
    assert plan["passes"] == -(-rows // rpp)
    assert plan["tiles"] * cols >= e > (plan["tiles"] - 1) * cols
    seen = np.zeros((top_k, cols, nch), np.int64)      # one block: its token's pairs
    for tid in range(TD.DOWN_THREADS):
        for pss in range(plan["passes"]):
            r = tid // lanes + pss * rpp
            if r < rows:
                for q in lane_chunks(plan, f, tid):
                    seen[r // cols, r % cols, q] += 1
    assert (seen == 1).all()
    if group is None:
        per = 16 // lanes
        for tid in range(lanes):
            sg = [q // 16 for q in lane_chunks(plan, f, tid)]
            assert sg == [i // per for i in range(len(sg))]


@pytest.mark.parametrize("t,top_k,f,e,group,cols,lanes,chunks,blocks", [
    (1, 8, 768, 2048, None, 8, 4, 12, 256),      # Qwen3-30B-A3B, kernel 8
    (8, 8, 768, 2048, None, 8, 4, 12, 2048),
    (1, 4, 1408, 2048, 32, 8, 8, 11, 256),       # Qwen1.5-MoE-A2.7B, kernel 13
    (1, 8, 768, 2048, 32, 8, 4, 12, 256),        # the all-planar Qwen3 shape
    (1, 1, 768, 2048, None, 16, 16, 3, 128),     # top_k 1 fills the block with 16 columns
    (1, 1, 1408, 2048, 32, 8, 32, 3, 256),
    (1, 2, 96, 100, 32, 8, 4, 2, 13)])            # F = 96: lanes capped by the row's 6 chunks
def test_down_plan_shapes(t, top_k, f, e, group, cols, lanes, chunks, blocks):
    plan = TD.down_plan(t, top_k, f, e, group)
    assert (plan["cols"], plan["lanes"], plan["chunks"], plan["blocks"]) == \
        (cols, lanes, chunks, blocks)
    assert plan["passes"] == 1


@pytest.mark.parametrize("groups", [range(16, 272, 16), range(272, 4112, 16),
                                    range(4112, 16400, 16)])
def test_down_planar_scale_index(groups):
    """Kernel 13 finds the scale group of chunk q (16 codes) as
    int((q + 0.5f) * (1.0f / (group / 16))) in float32, with no integer
    division: equal to q // (group / 16) for every chunk of a row that fits
    its shared memory (F < 2^17, so q < 2^13) and every group, powers of two
    or not (48, 96, ...)."""
    q = np.arange(1 << 13, dtype=np.int64)
    for group in groups:
        d = group // 16
        inv = np.float32(1) / np.float32(d)
        idx = ((q.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
        np.testing.assert_array_equal(idx, q // d, err_msg=f"group {group}")


def down_i8_model(hq, hst, ids, codes, sw, top_k):
    """Kernel 8's order of sums in numpy: each (pair, supergroup, column)
    int32 dot, then per column acc = acc + part * (hs * ws) rounded step by
    step in float32, pair by pair, supergroup by supergroup."""
    hq, hst, ids = hq.numpy(), hst.numpy(), ids.numpy()
    codes, sw = codes.numpy(), sw.numpy()
    pp, f = hq.shape
    t, nsg, e = pp // top_k, f // 256, codes.shape[2]
    out = np.zeros((t, e), np.float32)
    for ti in range(t):
        acc = np.zeros(e, np.float32)
        for j in range(top_k):
            p = ti * top_k + j
            for g in range(nsg):
                sl = slice(256 * g, 256 * (g + 1))
                part = hq[p, sl].astype(np.int64) @ codes[ids[p], sl].astype(np.int64)
                scale = np.float32(hst[g, p]) * sw[ids[p], g]
                acc = (acc + (part.astype(np.float32) * scale).astype(np.float32)
                       ).astype(np.float32)
        out[ti] = acc
    return out


def down_i8_case(t, top_k, f, e, g=6, seed=0, device="cpu"):
    """Inputs of kernel 8: hq int8 (P, F) with hst f32 (F/256, P) from
    quantize_activations, ids int32 with an expert repeated across pairs
    and across tokens, codes the (G, F, E) view of a contiguous (G, E, F)
    tensor, positive f32 scales (G, F/256, E)."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((t * top_k, f)).astype(np.float32))
    hq, hs = quantize_activations(h)
    ids = rng.integers(0, g, t * top_k).astype(np.int32)
    if top_k > 1:
        ids[1] = ids[0]                            # a repeat within token 0
    ids[-1] = ids[0]                               # and across tokens
    codes = torch.from_numpy(rng.integers(-127, 128, (g, e, f), dtype=np.int8))
    sw = torch.from_numpy((rng.random((g, f // 256, e)) * 2e-3 + 1e-5).astype(np.float32))
    return (hq.to(device), hs.t().to(device), torch.from_numpy(ids).to(device),
            codes.to(device).transpose(1, 2), sw.to(device))


@pytest.mark.parametrize("t,top_k,f,e", [(1, 8, 768, 64), (8, 8, 768, 40), (2, 1, 256, 37),
                                         (3, 4, 512, 20)])
def test_down_i8_order_model_equals_plain(t, top_k, f, e):
    """The plain version adds kernel 8's float32 steps in kernel 8's order:
    bit for bit against a numpy model of that order, so that a kernel which
    keeps the order must give the plain version's bits."""
    hq, hst, ids, codes, sw = down_i8_case(t, top_k, f, e, seed=t + f)
    got = TD.moe_decode_down_i8_ref(hq, hst, ids, codes, sw, top_k=top_k).numpy()
    ref = down_i8_model(hq, hst, ids, codes, sw, top_k)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# ------------------------------------------------------------------ card --
# (t, top_k, f, e): top_k 1, 2, 4, 8; T 1 and 8 with repeats; E off the tile
I8_CARD = [(1, 1, 256, 2048), (8, 1, 768, 204), (1, 2, 768, 100), (8, 2, 256, 2048),
           (1, 4, 768, 204), (8, 4, 768, 2048), (1, 8, 768, 2048), (8, 8, 768, 204),
           (1, 8, 256, 77), (8, 8, 256, 2048)]


@needs_cuda
@pytest.mark.parametrize("t,top_k,f,e", I8_CARD)
def test_down_i8_kernel_matches_plain_bit_for_bit(t, top_k, f, e):
    """Kernel 8: exact int32 supergroup dots and the plain version's float32
    steps in its order give its bits; two calls repeat bit for bit."""
    a = down_i8_case(t, top_k, f, e, g=16, seed=t * 100 + top_k, device="cuda")
    got = TD.moe_decode_down_i8(*a, top_k=top_k)
    again = TD.moe_decode_down_i8(*a, top_k=top_k)
    ref = TD.moe_decode_down_i8_ref(*a, top_k=top_k)
    assert torch.equal(got, again)
    assert torch.equal(got, ref)


# (t, top_k, f, e, group, scale dtype)
PLANAR_CARD = [(1, 1, 352, 2048, 16, "f32"), (8, 1, 1408, 204, 32, "bf16"),
               (1, 2, 1408, 100, 16, "bf16"), (8, 2, 352, 2048, 32, "f32"),
               (1, 4, 1408, 2048, 32, "bf16"), (8, 4, 1408, 2048, 32, "bf16"),
               (1, 4, 352, 204, 16, "f32"), (8, 4, 512, 204, 256, "f32"),
               (1, 8, 768, 2048, 32, "bf16"), (8, 8, 768, 2048, 256, "f32"),
               (1, 8, 1408, 77, 32, "f32"), (8, 8, 352, 2048, 16, "bf16"),
               (1, 4, 1440, 204, 96, "bf16"), (8, 2, 1440, 2048, 96, "f32"),
               (1, 8, 768, 2048, 48, "f32"), (8, 4, 768, 77, 48, "bf16")]


@needs_cuda
@pytest.mark.parametrize("t,top_k,f,e,group,sdt", PLANAR_CARD)
def test_down_planar_kernel_matches_plain(t, top_k, f, e, group, sdt):
    """Kernel 13 within the float32 reassociation bound of sum_tol (chip_smoke
    phase 3: 16 sqrt(K) roundings of the largest sum of |h w|, K = top_k *
    F), the pairs added in pair order; two calls repeat bit for bit."""
    rng = np.random.default_rng(t * 1000 + f + group)
    g = 6
    hw = torch.from_numpy(rng.standard_normal((t * top_k, f)).astype(np.float32)).cuda() \
        .to(torch.bfloat16)
    ids = rng.integers(0, g, t * top_k).astype(np.int32)
    if top_k > 1:
        ids[1] = ids[0]
    ids[-1] = ids[0]
    ids = torch.from_numpy(ids).cuda()
    codes = torch.from_numpy(rng.integers(-127, 128, (g, e, f), dtype=np.int8)).cuda() \
        .transpose(1, 2)
    scale = torch.from_numpy((rng.standard_normal((g, f // group, e)) * 0.02)
                             .astype(np.float32)).cuda().to(torch.float32 if sdt == "f32"
                                                            else torch.bfloat16)
    got = TD.moe_decode_down(hw, ids, codes, scale, top_k=top_k, group=group)
    again = TD.moe_decode_down(hw, ids, codes, scale, top_k=top_k, group=group)
    ref = TD.moe_decode_down_ref(hw, ids, codes, scale, top_k=top_k, group=group)
    w = TD.dequant_experts(codes[ids.long()], scale[ids.long()], group).float().abs()
    absdot = float(torch.bmm(hw.float().abs()[:, None], w).reshape(t, top_k, e).sum(1).max())
    tol = 16 * (top_k * f) ** 0.5 * 2.0 ** -24 * absdot
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= tol
