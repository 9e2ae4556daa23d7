"""Kernel 7 (``moe_decode_gate_up_i8``, csrc/moe_decode_i8.cu
gate_up_i8_kernel, int8 gate/up decode): its launch plan and a torch model
of its lane split on the CPU; the kernel against its plain version on the
card (skipped without one) over biases, ``act_limit``, every activation and
P up to 64. Each card case also checks that two calls repeat bit for bit.

The supergroup sums are exact integers whatever the lanes a row, and one
thread a column adds their corrections in supergroup order, then the bias,
then the activation, as the plain version does: the model gives the plain
version's h bit for bit. On the card only the activation's expf may round
differently from torch's sigmoid, so the kernel is held within two bf16
ulps of the largest output, as chip_smoke.py's phase 3 holds it."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

H100_SMS = 132
# (p, k, ff): Qwen3-30B-A3B (P = 8 and its T = 8 step), Qwen1.5-MoE-A2.7B's
# gate/up, gpt-oss's width rounded to supergroups, short rows, FF off the
# column tile
PLAN_SHAPES = [(8, 2048, 768), (64, 2048, 768), (4, 2048, 1408), (32, 2048, 1408),
               (16, 2816, 2880), (1, 256, 10), (2, 512, 100), (3, 768, 77), (8, 4096, 1536),
               (5, 1024, 352)]


def lane_chunks(plan, k, tid):
    """The chunks of its row that thread ``tid`` of a block holds, in the
    order it sums them: chunk lr + lanes * i for i < chunks."""
    lanes = plan["lanes"]
    lr = tid % lanes
    return [lr + lanes * i for i in range(plan["chunks"])]


@pytest.mark.parametrize("p,k,ff", PLAN_SHAPES)
def test_plan_covers_every_chunk_once(p, k, ff):
    """Every (gate or up, column, chunk) of a block is loaded by exactly one
    live lane in one pass; the row's lanes are an aligned power-of-two group
    of a warp (the shuffle), at most 16, so that a lane holds 16 / lanes
    chunks of each supergroup, one after another in its order (its sum of
    a supergroup is whole before the shuffle); the tiles cover FF."""
    plan = TD.gate_up_i8_plan(p, k, ff)
    cols, lanes, nch = plan["cols"], plan["lanes"], k // 16
    rows = 2 * cols
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 16 and 32 % lanes == 0
    assert plan["passes"] == 1 and rows * lanes <= TD.GATE_UP_THREADS
    assert plan["chunks"] * lanes == nch
    assert plan["tiles"] * cols >= ff > (plan["tiles"] - 1) * cols
    assert plan["blocks"] == plan["tiles"] * p
    per = 16 // lanes
    seen = np.zeros((2, cols, nch), np.int64)
    for tid in range(TD.GATE_UP_THREADS):
        r = tid // lanes
        if r >= rows:
            continue
        qs = lane_chunks(plan, k, tid)
        for i, q in enumerate(qs):
            seen[r // cols, r % cols, q] += 1
            assert q // 16 == i // per          # the lane's i-th chunk is in supergroup i / per
    assert (seen == 1).all()


@pytest.mark.parametrize("p,k,ff,cols,lanes,chunks,blocks", [
    (8, 2048, 768, 16, 8, 16, 384),       # Qwen3-30B-A3B, T = 1
    (64, 2048, 768, 16, 8, 16, 3072),     # its T = 8 step
    (4, 2048, 1408, 16, 8, 16, 352),      # Qwen1.5-MoE-A2.7B, T = 1
    (1, 256, 10, 16, 8, 2, 1)])           # one supergroup
def test_plan_shapes(p, k, ff, cols, lanes, chunks, blocks):
    """At the decode shapes a block holds 16 columns' 32 rows at 8 lanes a
    row (kernel 12's shape), and the grid gives at least one block an SM."""
    plan = TD.gate_up_i8_plan(p, k, ff)
    assert (plan["cols"], plan["lanes"], plan["chunks"], plan["blocks"]) == \
        (cols, lanes, chunks, blocks)
    if k >= 2048 and p >= 4:
        assert plan["blocks"] >= H100_SMS


@pytest.mark.parametrize("cols,lanes", [(2, 16), (4, 16), (8, 16), (16, 8), (32, 4)])
def test_plan_forced_columns(cols, lanes):
    """chip_smoke.py's column sweep: any forced power of two keeps the rows
    in one pass with at most 16 lanes a row."""
    plan = TD.gate_up_i8_plan(8, 2048, 768, cols=cols)
    assert (plan["cols"], plan["lanes"], plan["passes"]) == (cols, lanes, 1)


@pytest.mark.parametrize("k", [0, 128, 300, 2000])
def test_plan_refuses_k_off_the_supergroup(k):
    with pytest.raises(ValueError):
        TD.gate_up_i8_plan(8, k, 768)


# ------------------------------------------------ the order of the sums --
def lane_split_dots(xq, xst, ids, codes, sw, lanes):
    """Kernel 7's gate or up dots in torch: lane l of a row adds the exact
    int products of its chunks l, l + lanes, ... (16 K positions each);
    after its last chunk of a supergroup a butterfly over the row's lanes
    (xor lanes / 2 down to 1) forms the supergroup's int32 sum; then, per
    column, acc + part * (xs * sw) in float32, one rounding a step, in
    supergroup order."""
    p, k = xq.shape
    nsg, nch = k // 256, k // 16
    w = codes[ids.long()].long()                              # (P, K, N)
    prod = xq.long()[:, :, None] * w
    chunk = prod.reshape(p, nch, 16, -1).sum(2)               # (P, chunks, N)
    lane = torch.stack([chunk[:, l::lanes] for l in range(lanes)], 1)   # (P, lanes, cpl, N)
    per = 16 // lanes
    part = lane.reshape(p, lanes, nsg, per, -1).sum(3)        # each lane's share of a supergroup
    o = lanes // 2
    while o:
        part = part + part[:, torch.arange(lanes) ^ o]
        o //= 2
    sums = part[:, 0].to(torch.int32)                         # (P, nsg, N)
    acc = torch.zeros((p, codes.shape[2]), dtype=torch.float32)
    se = sw[ids.long()]
    for g in range(nsg):
        acc = acc + sums[:, g].float() * (xst[g][:, None] * se[:, g])
    return acc


def i8_case(p, k, ff, g, bias, seed=0):
    """Kernel 7's inputs: quantized rows, ids with a repeated expert, codes
    the (G, K, FF) view of a contiguous (G, FF, K) tensor, positive f32
    scales (G, K/256, FF), optional f32 biases (G, FF)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((p, k)).astype(np.float32))
    xq, xs = t_quant(x.to(torch.bfloat16))
    ids = rng.integers(0, g, p).astype(np.int32)
    ids[-1] = ids[0]
    out = [xq, xs.t(), torch.from_numpy(ids)]
    for _ in range(2):
        codes = torch.from_numpy(rng.integers(-127, 128, (g, ff, k), dtype=np.int8))
        sw = torch.from_numpy((np.abs(rng.standard_normal((g, k // 256, ff))) * 0.002
                               + 1e-5).astype(np.float32))
        out += [codes.transpose(1, 2), sw]
    for _ in range(2):
        out.append(torch.from_numpy(rng.standard_normal((g, ff)).astype(np.float32))
                   if bias else None)
    return out


ACTS = [("silu", 0.0), ("silu", 0.5), ("gelu", 0.0), ("swiglu_oai", 0.0)]


@pytest.mark.parametrize("act,limit", ACTS)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("p,k,ff", [(8, 1024, 48), (5, 768, 40)])
def test_lane_split_gives_the_plain_bits(act, limit, bias, p, k, ff):
    """At the plan's lanes and at every other lane count a row may take,
    the model's h is the plain version's, bit for bit, with and without
    biases, for every activation."""
    assert set(TD.ACTIVATIONS) == {a for a, _ in ACTS}
    xq, xst, ids, gc, gs, uc, us, gb, ub = i8_case(p, k, ff, 6, bias, seed=p + k + ff)
    ref = TD.moe_decode_gate_up_i8_ref(xq, xst, ids, gc, gs, uc, us, gb, ub,
                                       activation=act, act_limit=limit)
    plan_lanes = TD.gate_up_i8_plan(p, k, ff)["lanes"]
    li = ids.long()
    for lanes in sorted({plan_lanes, 1, 2, 4, 8, 16}):
        g = lane_split_dots(xq, xst, ids, gc, gs, lanes)
        u = lane_split_dots(xq, xst, ids, uc, us, lanes)
        if gb is not None:
            g, u = g + gb[li].float(), u + ub[li].float()
        h = TD._act(g, u, act, limit).to(torch.bfloat16)
        assert torch.equal(h, ref), lanes


def test_wrapper_on_the_cpu_is_the_plain_version():
    xq, xst, ids, gc, gs, uc, us, gb, ub = i8_case(4, 512, 32, 3, True, seed=1)
    got = TD.moe_decode_gate_up_i8(xq, xst, ids, gc, gs, uc, us, gb, ub)
    assert torch.equal(got, TD.moe_decode_gate_up_i8_ref(xq, xst, ids, gc, gs, uc, us, gb, ub))


# ------------------------------------------------------------------ card --
# (p, k, ff, g, biases, activation, act_limit)
CARD = [(8, 2048, 768, 128, False, "silu", 0.0),       # Qwen3-30B-A3B
        (64, 2048, 768, 128, False, "silu", 0.0),      # its T = 8 step
        (4, 2048, 1408, 60, False, "silu", 0.0),       # Qwen1.5-MoE-A2.7B
        (16, 1024, 352, 12, True, "silu", 7.0),
        (8, 2816, 2880, 8, True, "swiglu_oai", 0.0),   # gpt-oss's widths
        (8, 512, 100, 6, True, "gelu", 0.0),
        (3, 256, 77, 4, False, "silu", 0.0)]


@needs_cuda
@pytest.mark.parametrize("p,k,ff,g,bias,act,limit", CARD)
def test_kernel_matches_plain(p, k, ff, g, bias, act, limit):
    """Kernel 7 within 2^-7 max|ref| of its plain version (h is bf16: two
    ulps of the largest output); two calls repeat bit for bit."""
    a = [None if t is None else t.cuda() for t in i8_case(p, k, ff, g, bias, seed=p + k)]
    kw = dict(activation=act, act_limit=limit)
    got = TD.moe_decode_gate_up_i8(*a, **kw)
    again = TD.moe_decode_gate_up_i8(*a, **kw)
    ref = TD.moe_decode_gate_up_i8_ref(*a, **kw)
    assert torch.equal(got, again)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2.0 ** -7 * float(ref.float().abs().max())
