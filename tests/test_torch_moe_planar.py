"""The port's planar MoE kernels (12 moe_decode_gate_up, 13 moe_decode_down,
14 ragged_qmatmul) against the JAX package.

The plain versions, which a CPU tensor runs, are held against the Pallas
kernels in interpret mode (with the small blocks the JAX package's own tests
use) and against the JAX oracles ``moe_decode_ref`` / ``ragged_qmatmul_ref``;
the CUDA kernels are held against the plain versions on the card (skipped
without one). Both sides dequantize w = bf16(bf16(code) * bf16(scale)) and
sum exact bf16 x bf16 products in float32, so only the order of the sums
differs: rtol 1e-5, atol 1e-4 on float32 outputs at these sizes (the
tolerance of the planar GEMM's test), one bf16 ulp on h."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu.ops import moe_decode as JD
from ik_llama_cpp_tpu.ops import moe_qmm as JQ
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops import moe_qmm as TQ

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

BF16_ULP = 2.0 ** -8
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def planar_np(g, k, n, group, seed):
    """int8 codes (G, K, N) and f32 scales (G, K/group, N)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (g, k, n), dtype=np.int8)
    scale = (rng.standard_normal((g, k // group, n)) * 0.02).astype(np.float32)
    return codes, scale


def t_codes(codes, device="cpu"):
    """Stored (G, N, K), held as the (G, K, N) view, as the loader does."""
    return torch.from_numpy(codes.transpose(0, 2, 1).copy()).to(device).transpose(1, 2)


def experts_np(g, k, f, groups, sdt, seed=0, bias=False):
    """A planar or mixed-format expert set as numpy, with (gate, up, down)
    groups and scale dtypes ('f32' | 'bf16'); scales are rounded to their
    dtype once here so that both packages hold the same values."""
    rng = np.random.default_rng(1000 + seed)
    d = {}
    for i, (name, (kk, nn)) in enumerate((("gate", (k, f)), ("up", (k, f)), ("down", (f, k)))):
        d[name], sc = planar_np(g, kk, nn, groups[i], seed * 10 + i)
        d[name + "_s"] = np.array(jnp.asarray(sc, JDT[sdt[i]]).astype(jnp.float32))
        d[name + "_group"], d[name + "_dt"] = groups[i], sdt[i]
        d[name + "_b"] = rng.standard_normal((g, nn)).astype(np.float32) if bias else None
    return d


def to_jax(d):
    kw = {n + "_b": None if d[n + "_b"] is None else jnp.asarray(d[n + "_b"])
          for n in ("gate", "up", "down")}
    return JM.QuantExpertWeights(
        jnp.asarray(d["gate"]), jnp.asarray(d["gate_s"], JDT[d["gate_dt"]]),
        jnp.asarray(d["up"]), jnp.asarray(d["up_s"], JDT[d["up_dt"]]),
        jnp.asarray(d["down"]), jnp.asarray(d["down_s"], JDT[d["down_dt"]]),
        gate_group=d["gate_group"], up_group=d["up_group"], down_group=d["down_group"], **kw)


def to_torch(d, device="cpu"):
    kw = {}
    for n in ("gate", "up", "down"):
        kw[n] = t_codes(d[n], device)
        kw[n + "_s"] = torch.from_numpy(d[n + "_s"]).to(device, TDT[d[n + "_dt"]])
        kw[n + "_group"] = d[n + "_group"]
        kw[n + "_b"] = None if d[n + "_b"] is None else torch.from_numpy(d[n + "_b"]).to(device)
    return TM.QuantExpertWeights(**kw)


# (t, top_k, G, K, FF, group, scale dtype, biases)
GATE_UP = [(1, 4, 8, 128, 96, 32, "f32", False),      # single-token decode
           (4, 2, 8, 96, 64, 32, "bf16", False),      # K = 96, bf16 scales
           (2, 3, 5, 320, 160, 32, "f32", True),      # unaligned dims, biases
           (2, 2, 4, 512, 128, 256, "f32", False),    # supergroup codes on the planar kernel
           (1, 4, 6, 352, 128, 32, "bf16", True)]     # K = 11 * 32: no multiple of 256


@pytest.mark.parametrize("t,topk,g,k,f,group,sdt,bias", GATE_UP)
def test_gate_up_plain_matches_jax_kernel(t, topk, g, k, f, group, sdt, bias):
    """Kernel 12's function: h within one bf16 ulp of the Pallas kernel in
    interpret mode (the float32 sums take another order, which can move a
    value across a bf16 rounding boundary)."""
    rng = np.random.default_rng(t)
    d = experts_np(g, k, f, (group,) * 3, (sdt,) * 3, seed=k, bias=bias)
    xp = np.repeat(rng.standard_normal((t, k)).astype(np.float32), topk, axis=0)
    ids = rng.integers(0, g, t * topk).astype(np.int32)
    e, je = to_torch(d), to_jax(d)
    got = TD.moe_decode_gate_up(torch.from_numpy(xp).to(torch.bfloat16),
                                torch.from_numpy(ids), e.gate, e.gate_s, e.up, e.up_s,
                                e.gate_b, e.up_b, group=group).float().numpy()
    ref = JD.moe_decode_gate_up(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(ids), je.gate,
                                je.gate_s, je.up, je.up_s, gate_b=je.gate_b, up_b=je.up_b,
                                group=group, block_k=max(64, group), block_f=128,
                                interpret=True)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=2 * BF16_ULP, atol=1e-4)


@pytest.mark.parametrize("t,topk,g,f,e,group,sdt", [
    (1, 4, 8, 96, 128, 32, "f32"), (3, 2, 6, 320, 192, 32, "bf16"),
    (8, 2, 6, 352, 256, 32, "bf16"), (2, 2, 4, 256, 128, 256, "f32"),
    (2, 1, 5, 352, 128, 16, "f32"),       # top_k 1, group 16
    (1, 8, 6, 96, 204, 32, "bf16"),       # E off the kernel's column tile
    (8, 4, 3, 352, 100, 32, "bf16")])     # 3 experts for 4 pairs: repeats in and across tokens
def test_down_plain_matches_jax_kernel(t, topk, g, f, e, group, sdt):
    """Kernel 13's function against the Pallas kernel in interpret mode:
    the pairs of a token are added in pair order on both sides."""
    rng = np.random.default_rng(2)
    codes, scale = planar_np(g, f, e, group, seed=f)
    hw = rng.standard_normal((t * topk, f)).astype(np.float32)
    ids = rng.integers(0, g, t * topk).astype(np.int32)
    got = TD.moe_decode_down(torch.from_numpy(hw).to(torch.bfloat16), torch.from_numpy(ids),
                             t_codes(codes), torch.from_numpy(scale).to(TDT[sdt]),
                             top_k=topk, group=group).numpy()
    ref = np.asarray(JD.moe_decode_down(
        jnp.asarray(hw, jnp.bfloat16), jnp.asarray(ids), jnp.asarray(codes),
        jnp.asarray(scale, JDT[sdt]), top_k=topk, group=group, block_f=max(64, group),
        block_e=128, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("groups,sdt,bias,wbf", [
    ((32, 32, 32), ("bf16",) * 3, False, False),           # all planar
    ((256, 256, 32), ("f32", "f32", "bf16"), False, False),  # mixed: down stays planar
    ((32, 32, 32), ("f32",) * 3, True, False),             # per-expert biases
    ((256, 256, 32), ("f32", "f32", "bf16"), True, True)])  # weight before the FFN
def test_decode_ref_matches_jax_ref(groups, sdt, bias, wbf):
    """The whole planar decode FFN: the port's ``moe_decode_ref`` against the
    JAX oracle. h may differ by a bf16 ulp where the float32 sums round
    apart, which the down projection carries on: 0.5% of the largest output."""
    t, topk, g, k, f = 3, 2, 6, 256, 96
    rng = np.random.default_rng(7)
    d = experts_np(g, k, f, groups, sdt, seed=3, bias=bias)
    x = (rng.standard_normal((t, k)) * 0.5).astype(np.float32)
    w = rng.random((t, topk)).astype(np.float32)
    idx = np.stack([rng.choice(g, topk, replace=False) for _ in range(t)]).astype(np.int32)
    act = "swiglu_oai" if bias else "silu"
    got = TD.moe_decode_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx),
                            to_torch(d), activation=act, weight_before_ffn=wbf).numpy()
    ref = np.asarray(JD.moe_decode_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                       to_jax(d), activation=act, weight_before_ffn=wbf))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * np.abs(ref).max())


def _sizes(m, weights, covered=None):
    w = np.asarray(weights, np.float64)
    total = m if covered is None else covered
    counts = (w / w.sum() * total).astype(np.int64)
    counts[0] += total - counts.sum()
    return counts.astype(np.int32)


# (M, K, N, G, group, scale dtype, relative sizes, rows covered | None = all)
RAGGED = [(64, 64, 128, 4, 32, "f32", [1, 1, 1, 1], None),       # even split
          (96, 64, 128, 4, 32, "bf16", [5, 1, 1, 3], None),      # boundary crossings
          (40, 64, 128, 4, 16, "f32", [1, 0, 2, 1], None),       # an empty expert, group 16
          (8, 96, 128, 8, 32, "bf16", [1, 0, 3, 0, 0, 2, 1, 1], None),   # decode-sized, K = 96
          (128, 352, 256, 3, 32, "bf16", [2, 3, 1], None),       # K = 11 * 32
          (64, 512, 128, 4, 256, "f32", [3, 1, 0, 2], None),     # supergroup codes
          (37, 64, 128, 4, 32, "f32", [10, 0, 20, 2], 32)]       # padding rows past the sum


@pytest.mark.parametrize("m,k,n,g,group,sdt,weights,covered", RAGGED)
def test_ragged_plain_matches_jax_kernel_and_oracle(m, k, n, g, group, sdt, weights, covered):
    """Kernel 14's function against the Pallas kernel in interpret mode and
    the JAX oracle, over the rows the groups cover: rows at or past
    sum(group_sizes) are undefined in the JAX package (the port's plain
    version gives them to the last expert, its kernel leaves them
    unwritten)."""
    rng = np.random.default_rng(m)
    codes, scale = planar_np(g, k, n, group, seed=m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    gs = _sizes(m, weights, covered)
    live = int(gs.sum())
    got = TQ.ragged_qmatmul(torch.from_numpy(x).to(torch.bfloat16), t_codes(codes),
                            torch.from_numpy(scale).to(TDT[sdt]), torch.from_numpy(gs),
                            group=group).numpy()
    assert got.shape == (m, n)
    jx, jc, js = jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale, JDT[sdt])
    ker = np.asarray(JQ.ragged_qmatmul(jx, jc, js, jnp.asarray(gs), group=group, block_m=32,
                                       block_n=128, block_k=max(64, group), interpret=True))
    np.testing.assert_allclose(got[:live], ker[:live], rtol=1e-5, atol=1e-4)
    ref = np.asarray(JQ.ragged_qmatmul_ref(jx[:live], jc, js, jnp.asarray(gs), group=group))
    np.testing.assert_allclose(got[:live], ref, rtol=1e-5, atol=1e-4)


def test_ragged_single_group_equals_planar_gemm():
    """One group that owns every row is the planar GEMM's plain version."""
    from ik_llama_cpp_tpu_torch.ops.qmatmul import qmatmul_ref
    codes, scale = planar_np(1, 64, 128, 32, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((48, 64)).astype(np.float32))
    got = TQ.ragged_qmatmul_ref(x, torch.from_numpy(codes), torch.from_numpy(scale),
                                torch.tensor([48], dtype=torch.int32), group=32)
    ref = qmatmul_ref(x, torch.from_numpy(codes[0]), torch.from_numpy(scale[0]), group=32)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("group,sdt", [(32, "bf16"), (256, "f32"), (16, "f32")])
def test_planar_decode_kernels_match_plain(group, sdt):
    """Kernels 12 and 13 against their plain versions on the card: h within
    one bf16 ulp, the down sum to float32 summation order."""
    g, k, f, topk, t = 12, 1024, 352 if group != 256 else 512, 4, 8
    d = experts_np(g, k, f, (group,) * 3, (sdt,) * 3, seed=group, bias=True)
    e = to_torch(d, "cuda")
    rng = np.random.default_rng(group)
    xp = torch.from_numpy(rng.standard_normal((t * topk, k)).astype(np.float32)).cuda().to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, g, t * topk).astype(np.int32)).cuda()
    a = (xp, ids, e.gate, e.gate_s, e.up, e.up_s, e.gate_b, e.up_b)
    h, hr = TD.moe_decode_gate_up(*a, group=group), TD.moe_decode_gate_up_ref(*a, group=group)
    torch.testing.assert_close(h.float(), hr.float(), rtol=2 * BF16_ULP, atol=1e-4)
    out = TD.moe_decode_down(hr, ids, e.down, e.down_s, top_k=topk, group=group)
    ref = TD.moe_decode_down_ref(hr, ids, e.down, e.down_s, top_k=topk, group=group)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@needs_cuda
@pytest.mark.parametrize("m,k,n,g,group,sdt,weights,covered", RAGGED)
def test_ragged_kernel_matches_plain(m, k, n, g, group, sdt, weights, covered):
    """Kernel 14 against its plain version on the card, over the live rows."""
    rng = np.random.default_rng(m)
    codes, scale = planar_np(g, k, n, group, seed=m + k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda().to(torch.bfloat16)
    gs = torch.from_numpy(_sizes(m, weights, covered)).cuda()
    live = int(gs.sum())
    a = (x, t_codes(codes, "cuda"), torch.from_numpy(scale).cuda().to(TDT[sdt]), gs)
    got, ref = TQ.ragged_qmatmul(*a, group=group), TQ.ragged_qmatmul_ref(*a, group=group)
    torch.testing.assert_close(got[:live], ref[:live], rtol=1e-5, atol=1e-4)
