"""Kernel 12 (``moe_decode_gate_up``, planar gate/up decode): its launch
plan and a plain model of its order of sums on the CPU; the kernel against
its plain version on the card (skipped without one) over biases,
``act_limit``, every activation, f32 and bf16 scales, groups 16-256 (and
48, which is no power of two) and P up to 64. Each card case also checks
that two calls repeat bit for bit."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import moe_decode as TD

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

H100_SMS = 132
# (p, k, ff): the paths' decode shapes (Qwen1.5-MoE-A2.7B P=4 FF 1408, the
# all-planar Qwen3-30B-A3B P=8 FF 768, and their T=8 steps), gpt-oss's
# width, rows shorter than 32 chunks, FF off the column tile
PLAN_SHAPES = [(4, 2048, 1408), (8, 2048, 768), (32, 2048, 1408), (64, 2048, 768),
               (16, 2880, 2880), (1, 1024, 352), (2, 96, 100), (3, 48, 30), (4, 512, 77),
               (8, 4096, 1536), (1, 16, 10)]


def lane_chunks(plan, k, tid):
    """The chunks of its row that thread ``tid`` of a block holds: the
    kernel's indexing, chunk lr + lanes * i for i < chunks, within the row."""
    lanes, nch = plan["lanes"], k // 16
    lr = tid % lanes
    return [lr + lanes * i for i in range(plan["chunks"]) if lr + lanes * i < nch]


@pytest.mark.parametrize("p,k,ff", PLAN_SHAPES)
def test_gate_up_plan_covers_every_row_once(p, k, ff):
    """Every (gate or up, column, chunk) of a block is loaded by exactly one
    live lane in one pass; the row's lanes are an aligned power-of-two group
    of a warp (the shuffle); the tiles cover FF; the row and the dots fit
    the block's shared memory."""
    plan = TD.gate_up_plan(p, k, ff)
    cols, lanes, nch = plan["cols"], plan["lanes"], k // 16
    rows = 2 * cols
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert plan["passes"] == 1 and rows * lanes <= TD.GATE_UP_THREADS
    assert plan["tiles"] * cols >= ff > (plan["tiles"] - 1) * cols
    assert plan["blocks"] == plan["tiles"] * p
    assert 2 * k + 8 * cols <= TD.SMEM_LIMIT
    seen = np.zeros((2, cols, nch), np.int64)
    for tid in range(TD.GATE_UP_THREADS):
        r = tid // lanes
        if r < rows:
            for q in lane_chunks(plan, k, tid):
                seen[r // cols, r % cols, q] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("p,k,ff,cols,lanes,chunks,blocks", [
    (4, 2048, 1408, 16, 8, 16, 352),      # Qwen1.5-MoE-A2.7B, T = 1
    (8, 2048, 768, 16, 8, 16, 384),       # the all-planar Qwen3-30B-A3B shape
    (64, 2048, 768, 16, 8, 16, 3072),     # its T = 8 step
    (2, 96, 100, 32, 4, 2, 8)])           # K = 96: lanes capped by the row's 6 chunks
def test_gate_up_plan_shapes(p, k, ff, cols, lanes, chunks, blocks):
    """At the decode shapes a block holds 16 columns' 32 rows at 8 lanes a
    row, and the grid gives at least one block an SM of the H100."""
    plan = TD.gate_up_plan(p, k, ff)
    assert (plan["cols"], plan["lanes"], plan["chunks"], plan["blocks"]) == \
        (cols, lanes, chunks, blocks)
    if k >= 512:
        assert plan["blocks"] >= H100_SMS


@pytest.mark.parametrize("cols", [2, 4, 8, 16, 32])
def test_gate_up_plan_forced_columns(cols):
    """The column sweep of chip_smoke.py: any forced power of two keeps the
    rows in one pass (4 columns: 32 lanes a row, the first port's order)."""
    plan = TD.gate_up_plan(4, 2048, 1408, cols=cols)
    assert plan["cols"] == cols and plan["passes"] == 1
    assert plan["lanes"] == min(32, TD.GATE_UP_THREADS // (2 * cols))


def gate_up_model(x, w, lanes):
    """Kernel 12's order of sums in numpy, float32: lane l of a row adds the
    exact bf16 x bf16 products of its chunks l, l + lanes, ... (16 K
    positions each, in order) with one rounding each (the fused
    multiply-add), then a butterfly over the row's lanes (xor lanes / 2
    down to 1) forms lane 0's dot. x (P, K) and w (P, K, N) hold bf16
    values as float32."""
    p, k = x.shape
    nch = k // 16
    prod = (x[:, :, None] * w).astype(np.float32)          # exact in float32
    acc = np.zeros((p, lanes, w.shape[2]), np.float32)
    for i in range(-(-nch // lanes)):
        for lr in range(lanes):
            q = lr + lanes * i
            if q < nch:
                for j in range(16):
                    acc[:, lr] = (acc[:, lr] + prod[:, 16 * q + j]).astype(np.float32)
    o = lanes // 2
    while o:
        acc = (acc + acc[:, np.arange(lanes) ^ o]).astype(np.float32)
        o //= 2
    return acc[:, 0]


def gate_up_case(p, k, ff, g, group, sdt, bias, seed=0, device="cpu"):
    """Kernel 12's inputs: bf16 rows, ids with a repeated expert, codes the
    (G, K, FF) view of a contiguous (G, FF, K) tensor, scales f32 or bf16
    (G, K/group, FF), optional f32 biases (G, FF)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((p, k)).astype(np.float32)).to(torch.bfloat16)
    ids = rng.integers(0, g, p).astype(np.int32)
    ids[-1] = ids[0]
    dt = torch.float32 if sdt == "f32" else torch.bfloat16
    out = [x.to(device), torch.from_numpy(ids).to(device)]
    for _ in range(2):
        codes = torch.from_numpy(rng.integers(-127, 128, (g, ff, k), dtype=np.int8))
        sc = torch.from_numpy((rng.standard_normal((g, k // group, ff)) * 0.02)
                              .astype(np.float32)).to(dt)
        out += [codes.to(device).transpose(1, 2), sc.to(device)]
    for _ in range(2):
        out.append(torch.from_numpy(rng.standard_normal((g, ff)).astype(np.float32)).to(device)
                   if bias else None)
    return out


@pytest.mark.parametrize("p,k,ff,group,sdt", [(4, 2048, 48, 256, "f32"), (8, 2048, 24, 32, "bf16"),
                                             (2, 96, 20, 48, "f32"), (3, 512, 16, 16, "bf16")])
def test_gate_up_order_model_against_plain(p, k, ff, group, sdt):
    """The plain version's gate and up dots are the model's up to float32
    reassociation (sum_tol of chip_smoke.py: 16 sqrt(K) roundings of the
    largest sum of |x w|), and h from the model's dots is the plain h within
    one bf16 ulp: the kernel's order of sums is an order the plain version's
    tolerance covers. At 32 lanes a row (a forced plan) it is the order of
    the kernel's first port (one warp a column, chunks lane, lane + 32,
    ..., then xor 16 .. 1)."""
    x, ids, gc, gs, uc, us, gb, ub = gate_up_case(p, k, ff, 6, group, sdt, True, seed=k + ff)
    lanes = TD.gate_up_plan(p, k, ff)["lanes"]
    li = ids.long()
    xf = x.float().numpy()
    dots = []
    for codes, sc, b in ((gc, gs, gb), (uc, us, ub)):
        w = TD.dequant_experts(codes[li], sc[li], group).float().numpy()
        model = gate_up_model(xf, w, lanes)
        plain = TD._pairs_planar(x, codes, sc, ids, group).numpy()
        absdot = (np.abs(xf)[:, :, None] * np.abs(w)).sum(1).max()
        assert np.abs(model - plain).max() <= 16 * k ** 0.5 * 2.0 ** -24 * absdot
        dots.append(torch.from_numpy(model) + b[li])
    h_model = TD._act(dots[0], dots[1], "silu", 0.0).to(torch.bfloat16).float()
    h_plain = TD.moe_decode_gate_up_ref(x, ids, gc, gs, uc, us, gb, ub, group=group).float()
    assert float((h_model - h_plain).abs().max()) <= 2.0 ** -8 * float(h_plain.abs().max())


# ------------------------------------------------------------------ card --
# (p, k, ff, g, group, scale dtype, biases, activation, act_limit)
CARD = [(4, 2048, 1408, 60, 256, "f32", False, "silu", 0.0),       # Qwen1.5-MoE-A2.7B
        (8, 2048, 768, 128, 32, "bf16", False, "silu", 0.0),       # all-planar Qwen3
        (32, 2048, 1408, 60, 256, "f32", False, "silu", 0.0),
        (64, 2048, 768, 128, 32, "bf16", False, "silu", 0.0),
        (16, 1024, 352, 12, 16, "f32", True, "silu", 7.0),
        (8, 2880, 2880, 8, 32, "bf16", True, "swiglu_oai", 0.0),   # gpt-oss's widths
        (8, 512, 100, 6, 64, "bf16", True, "gelu", 0.0),
        (2, 96, 100, 4, 48, "f32", False, "silu", 0.0),
        (5, 768, 77, 6, 48, "bf16", True, "silu", 0.0)]


@needs_cuda
@pytest.mark.parametrize("p,k,ff,g,group,sdt,bias,act,limit", CARD)
def test_gate_up_kernel_matches_plain(p, k, ff, g, group, sdt, bias, act, limit):
    """Kernel 12 within 2^-7 max|ref| of its plain version (h is bf16: two
    ulps of the largest output, as chip_smoke.py's phase 3 holds it); two
    calls repeat bit for bit."""
    a = gate_up_case(p, k, ff, g, group, sdt, bias, seed=p + k, device="cuda")
    kw = dict(group=group, activation=act, act_limit=limit)
    got = TD.moe_decode_gate_up(*a, **kw)
    again = TD.moe_decode_gate_up(*a, **kw)
    ref = TD.moe_decode_gate_up_ref(*a, **kw)
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2.0 ** -7 * float(ref.float().abs().max())
