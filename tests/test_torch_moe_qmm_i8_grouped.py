"""Kernel 10 (``ragged_qmatmul_i8``, csrc/moe_qmm_i8.cu
ragged_i8_wgmma_kernel): its plan, its work list, a torch model of its
sweeps and of its order of sums against the plain version (bit for bit) and
the JAX package, and the kernel against its plain version on the card
(skipped without one).

The kernel computes each supergroup's exact int32 sums with the int8
warpgroup MMA, a sweep of 64 tokens by 128 expert columns at a time, and
folds them as acc + part * (xs * sw), rounded at each step, in supergroup
order: the plain version's expression and order. So the model, and the
kernel, give ``ragged_qmatmul_i8_ref``'s bits; against the JAX oracle they
hold the tolerance of tests/test_torch_moe_qmm.py (rtol 1e-5, atol 1e-5)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe_qmm as JQ
from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import moe_qmm as TQ
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

from test_torch_moe_qmm_grouped import ragged_items, sizes

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")
SMS = _cuda.DEFAULT_SMS


# ------------------------------------------------------------- the plan --
@pytest.mark.parametrize("m,n,k,g", [
    (4096, 768, 2048, 128),     # Qwen3-30B-A3B gate/up: phase 3's row 10, the overflow pass
    (4096, 2048, 768, 128),     # its down projection
    (2048, 1408, 2048, 60),     # Qwen1.5-MoE-A2.7B gate/up (phase 12)
    (40000, 512, 1024, 8), (1, 128, 256, 1), (17, 96, 512, 1024), (300, 1000, 256, 5)])
def test_plan_fills_the_card(m, n, k, g):
    """A pure function of the shapes and the SM count: 64 tokens a sweep,
    128 columns;
    the grid one block an SM, or the most sweeps a call can have where
    those are fewer; no group sizes give more sweeps than it counts."""
    plan = TQ.ragged_i8_plan(m, n, k, g, SMS)
    assert plan == TQ.ragged_i8_plan(m, n, k, g, SMS)
    assert plan["tm"] == TQ.RAGGED_I8_TM == 64
    assert plan["tn"] == TQ.RAGGED_I8_TN and plan["n_tiles"] == -(-n // TQ.RAGGED_I8_TN)
    assert plan["sweeps"] == plan["n_tiles"] * (-(-m // plan["tm"]) + min(g, m))
    assert plan["blocks"] == min(plan["sweeps"], SMS)
    if plan["sweeps"] >= SMS:
        assert plan["blocks"] == SMS
    for kind in ("random", "skewed", "one", "sparse", "past_m"):
        if g >= 3 and m >= g:
            got = ragged_items(plan, sizes(kind, m, g, seed=g), m)
            assert sum(map(len, got)) <= plan["sweeps"]


@pytest.mark.parametrize("m,g,sweeps", [
    (4096, 128, 6 * (4096 // 64 + 128)),     # 32 rows an expert, phase 3's row 10
    (40000, 8, 6 * (-(-40000 // 64) + 8))])  # 5,000 rows an expert
def test_plan_token_tile_is_the_kernels_one_form(m, g, sweeps):
    """The kernel has one form, 64 tokens a sweep, however many rows the
    experts average; the most sweeps count its token tiles."""
    plan = TQ.ragged_i8_plan(m, 768, 2048, g, SMS)
    assert plan["tm"] == 64 and plan["sweeps"] == sweeps


@pytest.mark.parametrize("m,n,k,g,sms", [
    (64, 128, 128, 4, SMS),           # K not a multiple of 256
    (64, 128, 384, 4, SMS),
    (64, 128, 0, 4, SMS),
    (64, 128, 256, 1025, SMS),        # more groups than the rows map holds
    (64, 128, 256, 0, SMS),
    (64, 128, 256, -1, SMS),
    (0, 128, 256, 4, SMS),            # no rows
    (64, 0, 256, 4, SMS),
    (64, 128, 256, 4, 0)])            # no SMs to launch on
def test_plan_refuses_what_the_kernel_does_not_take(m, n, k, g, sms):
    with pytest.raises(ValueError):
        TQ.ragged_i8_plan(m, n, k, g, sms)


# --------------------------------------------------------- the work list --
@pytest.mark.parametrize("kind", ["random", "skewed", "zero", "one", "sparse", "past_m"])
@pytest.mark.parametrize("m,n,g,blocks", [
    (4096, 768, 128, 132),       # row 10 and the overflow pass
    (4096, 2048, 128, 132),      # the down shape
    (2048, 1408, 60, 132),       # Qwen1.5-MoE-A2.7B
    (300, 768, 16, 7), (20, 384, 8, 1)])
def test_sweeps_store_every_live_row_once(kind, m, n, g, blocks):
    """Every live row is stored exactly once in each column tile, by a
    sweep of its own expert (a token tile that runs into the next expert's
    rows stores only its own); an expert's sweeps of a column tile are
    consecutive, token tiles in order; each block takes every blocks-th
    sweep; empty experts and rows past the live ones get nothing."""
    gs = sizes(kind, m, g, seed=m + g + 1)
    plan = dict(TQ.ragged_i8_plan(m, n, 2048, g, SMS), blocks=blocks)
    got = ragged_items(plan, gs, m)
    ends = np.minimum(np.cumsum(gs), m)
    starts = np.concatenate([[0], ends[:-1]])
    owner = np.full(m, -1)
    for e in range(g):
        owner[starts[e]:ends[e]] = e
    stored = np.zeros((m, plan["n_tiles"]), np.int64)
    order = []
    for b, sweeps in enumerate(got):
        assert [s[0] for s in sweeps] == list(range(b, b + blocks * len(sweeps), blocks))
        for u, e, n0, m0, m_end in sweeps:
            assert starts[e] <= m0 < m_end <= min(m0 + plan["tm"], ends[e])
            assert (owner[m0:m_end] == e).all()
            stored[m0:m_end, n0 // plan["tn"]] += 1
            order.append((u, e, n0, m0))
    live = owner >= 0
    assert (stored[live] == 1).all() and (stored[~live] == 0).all()
    order.sort()
    runs = [(e, n0) for _, e, n0, _ in order]
    # an (expert, column tile)'s sweeps form one run; experts in order
    seen = [runs[0]] if runs else []
    for key in runs[1:]:
        if key != seen[-1]:
            assert key not in seen
            seen.append(key)
    assert [e for e, _ in seen] == sorted(e for e, _ in seen)


# ------------------------------------------------ the order of the sums --
def sweep_model(xq, xs, codes, sw, gs, tm, tn=TQ.RAGGED_I8_TN):
    """The kernel's arithmetic in torch on the CPU: per sweep (expert,
    tn columns, tm tokens), per supergroup the exact int32 sums (int64
    products, which the int8 MMA's int32 sums equal), folded as acc + part
    * (xs * sw) in float32, one rounding a step, in supergroup order; only
    the expert's own rows stored. xq int8 (M, K), xs f32 (M, K/256), codes
    int8 (G, K, N), sw f32 (G, K/256, N). Rows past the live ones stay
    NaN."""
    m, k = xq.shape
    n = codes.shape[2]
    out = torch.full((m, n), float("nan"))
    plan = {"tm": tm, "tn": tn, "n_tiles": -(-n // tn), "blocks": 1}
    for _, e, n0, m0, m_end in ragged_items(plan, gs, m)[0]:
        cols = slice(n0, min(n0 + tn, n))
        rows = slice(m0, m_end)
        acc = torch.zeros((m_end - m0, cols.stop - cols.start), dtype=torch.float32)
        for g in range(k // 256):
            ks = slice(256 * g, 256 * (g + 1))
            part = (xq[rows, ks].long() @ codes[e, ks, cols].long()).to(torch.int32)
            acc = acc + part.float() * (xs[rows, g:g + 1] * sw[e, g:g + 1, cols])
        out[rows, cols] = acc
    return out


def i8_case(m, k, n, g, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, xs = t_quant(torch.from_numpy(x).to(torch.bfloat16))
    codes = rng.integers(-127, 128, (g, k, n), dtype=np.int8)
    sw = (np.abs(rng.standard_normal((g, k // 256, n))) * 0.02 + 1e-4).astype(np.float32)
    return xq, xs, codes, sw


def case_sizes(kind, m, g, seed):
    if kind == "one_row":                 # groups of a single row among empty ones
        out = np.zeros(g, np.int64)
        out[::2] = 1
        return out
    if kind == "mid_tile":                # every other start inside a 64-token tile
        return np.full(g, m // g)
    return sizes(kind, m, g, seed)


# m, k, n, g, sizes: skewed, single-row groups, zero, mid-tile, Qwen1.5's
# 60 experts of N 1408, the down shape's K 768, a sum past M
MODEL_CASES = [(256, 512, 256, 8, "skewed"), (96, 256, 128, 12, "one_row"),
               (64, 256, 128, 4, "zero"), (192, 512, 320, 6, "mid_tile"),
               (240, 256, 1408, 60, "random"), (160, 768, 384, 8, "skewed"),
               (100, 256, 200, 5, "past_m")]


@pytest.mark.parametrize("m,k,n,g,kind", MODEL_CASES)
def test_sweep_model_gives_the_plain_bits(m, k, n, g, kind):
    """The model of the kernel's sweeps and fold gives the plain version's
    bits on every live row, and the JAX oracle within rtol 1e-5, atol
    1e-5."""
    xq, xs, codes, sw = i8_case(m, k, n, g, seed=m + n)
    gs = case_sizes(kind, m, g, seed=m).astype(np.int32)
    live = min(int(gs.sum()), m)
    tc, tsw, tgs = torch.from_numpy(codes), torch.from_numpy(sw), torch.from_numpy(gs)
    ref = TQ.ragged_qmatmul_i8_ref(xq, xs, tc, tsw, tgs)
    got = sweep_model(xq, xs, tc, tsw, gs, TQ.ragged_i8_plan(m, n, k, g, SMS)["tm"])
    assert torch.equal(got[:live], ref[:live])
    assert torch.isnan(got[live:]).all()
    jref = JQ.ragged_qmatmul_i8_ref(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                                    jnp.asarray(codes), jnp.asarray(sw), jnp.asarray(gs))
    np.testing.assert_allclose(got[:live].numpy(), np.asarray(jref)[:live], rtol=1e-5, atol=1e-5)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version, through the transposed scales
    the kernel reads by strides."""
    xq, xs, codes, sw = i8_case(128, 512, 256, 4, seed=3)
    gs = torch.tensor([30, 0, 70, 20], dtype=torch.int32)
    tc = torch.from_numpy(codes.transpose(0, 2, 1).copy()).transpose(1, 2)
    got = TQ.ragged_qmatmul_i8(xq, xs.t(), tc, torch.from_numpy(sw), gs)
    ref = TQ.ragged_qmatmul_i8_ref(xq, xs, tc, torch.from_numpy(sw), gs)
    assert torch.equal(got, ref)


# ------------------------------------------------------- on the card --
# m, k, n, g, sizes: the two Qwen3 shapes (skewed, zero, mid-tile), the
# overflow-like sizes of a few live experts, single-row groups, Qwen1.5's
# gate/up, N off the column tile, K 256, a sum past M
CARD = [(4096, 2048, 768, 128, "skewed"), (4096, 2048, 768, 128, "zero"),
        (4096, 2048, 768, 128, "mid_tile"), (4096, 768, 2048, 128, "skewed"),
        (4096, 2048, 768, 128, "sparse"), (512, 512, 256, 64, "one_row"),
        (2048, 2048, 1408, 60, "random"), (300, 512, 320, 5, "skewed"),
        (200, 256, 1000, 16, "past_m"), (17, 256, 128, 3, "one")]


def t_codes(codes):
    """Stored (G, N, K), held as the (G, K, N) view, as the loader does."""
    return torch.from_numpy(codes.transpose(0, 2, 1).copy()).cuda().transpose(1, 2)


@needs_cuda
@pytest.mark.parametrize("m,k,n,g,kind", CARD)
def test_kernel_gives_the_plain_bits(m, k, n, g, kind):
    """Kernel 10 against its plain version on every live row, bit for bit;
    two calls repeat."""
    xq, xs, codes, sw = i8_case(m, k, n, g, seed=m + k)
    gs = torch.from_numpy(case_sizes(kind, m, g, seed=m).astype(np.int32)).cuda()
    live = min(int(gs.sum()), m)
    xq, xs, c, s = xq.cuda(), xs.cuda(), t_codes(codes), torch.from_numpy(sw).cuda()
    ref = TQ.ragged_qmatmul_i8_ref(xq, xs, c, s, gs)
    got = TQ.ragged_qmatmul_i8(xq, xs.t(), c, s, gs)
    assert torch.equal(got[:live], ref[:live])
    assert torch.equal(TQ.ragged_qmatmul_i8(xq, xs.t(), c, s, gs)[:live], got[:live])
