"""The port's MoE prefill kernels (9 and 10) against the JAX package.

The plain versions, which a CPU tensor runs, are held against the Pallas
kernels in interpret mode and against the JAX oracle
``ragged_qmatmul_i8_ref``; the CUDA kernels against the plain versions on
the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu.ops import moe_qmm as JQ
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.ops import moe_qmm as TQ
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

from test_torch_moe_decode import experts_np, to_jax, to_torch

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


def _ragged_case(m, k, n, g, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, xs = t_quant(torch.from_numpy(x).to(torch.bfloat16))
    codes = rng.integers(-127, 128, (g, k, n), dtype=np.int8)
    sw = (np.abs(rng.standard_normal((g, k // 256, n))) * 0.02 + 1e-4).astype(np.float32)
    return xq, xs, codes, sw


def _torch_codes(codes, device="cpu"):
    return torch.from_numpy(codes.transpose(0, 2, 1).copy()).to(device).transpose(1, 2)


@pytest.mark.parametrize("m,k,n,sizes", [
    (64, 256, 128, [16, 16, 16, 16]),              # even split
    (96, 256, 128, [50, 6, 6, 34]),                # group starts mid-tile
    (40, 512, 128, [10, 0, 20, 10]),               # an empty group
    (8, 256, 128, [1, 0, 3, 0, 0, 2, 1, 1]),       # decode-sized, sparse
    (48, 256, 128, [0, 0, 0, 0]),                  # no rows at all
    (72, 256, 96, [5, 30, 0, 9]),                  # rows past sum(group_sizes)
])
def test_ragged_plain_matches_jax(m, k, n, sizes):
    """Kernel 10's function: the plain version against the JAX oracle and
    the Pallas kernel in interpret mode, on rows < sum(group_sizes) (what
    the kernels leave past that is undefined)."""
    g = len(sizes)
    xq, xs, codes, sw = _ragged_case(m, k, n, g, seed=m + n)
    gs = np.asarray(sizes, np.int32)
    got = TQ.ragged_qmatmul_i8(xq, xs.t(), _torch_codes(codes), torch.from_numpy(sw),
                               torch.from_numpy(gs)).numpy()
    jxq, jxs = jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy())
    refs = [JQ.ragged_qmatmul_i8_ref(jxq, jxs, jnp.asarray(codes), jnp.asarray(sw),
                                     jnp.asarray(gs)),
            JQ.ragged_qmatmul_i8(jxq, jxs.T, jnp.asarray(codes), jnp.asarray(sw),
                                 jnp.asarray(gs), block_m=128, block_n=128,
                                 interpret=True)]
    live = int(gs.sum())
    for ref in refs:
        np.testing.assert_allclose(got[:live], np.asarray(ref)[:live], rtol=1e-5, atol=1e-5)


def test_ragged_plain_rows_past_the_groups_use_the_last_expert():
    xq, xs, codes, sw = _ragged_case(24, 256, 64, 3, seed=4)
    gs = np.asarray([4, 0, 6], np.int32)
    got = TQ.ragged_qmatmul_i8_ref(xq, xs, _torch_codes(codes), torch.from_numpy(sw),
                                   torch.from_numpy(gs)).numpy()
    ref = JQ.ragged_qmatmul_i8_ref(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                                   jnp.asarray(codes), jnp.asarray(sw), jnp.asarray(gs))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def _buckets(sizes, k, r, seed):
    """Capacity buckets as the fused path builds them: (G, R, K) int8 rows,
    zero past each expert's rows, scales (G, K/256, R), live experts first."""
    rng = np.random.default_rng(seed)
    g = len(sizes)
    x = rng.standard_normal((g, r, k)).astype(np.float32)
    xq, xs = t_quant(torch.from_numpy(x.reshape(g * r, k)).to(torch.bfloat16))
    valid = np.arange(r)[None, :] < np.asarray(sizes)[:, None]
    xq = np.where(valid[..., None], xq.numpy().reshape(g, r, k), 0).astype(np.int8)
    xs = np.where(valid[..., None], xs.numpy().reshape(g, r, k // 256), 0.0)
    xst = np.ascontiguousarray(xs.transpose(0, 2, 1)).astype(np.float32)
    key = np.where(np.asarray(sizes) > 0, np.arange(g), 2 * g)
    eids = np.argsort(key, kind="stable").astype(np.int32)
    return xq, xst, eids, np.int32((np.asarray(sizes) > 0).sum())


@pytest.mark.parametrize("sizes", [[5, 0, 9, 2, 0, 8], [8, 8, 8, 8, 8, 8]])
@pytest.mark.parametrize("activation", ["silu", "swiglu_oai"])
def test_fused_plain_matches_jax_kernel(sizes, activation):
    """Kernel 9's function: the plain version against the Pallas kernel in
    interpret mode (K = FF = E = 256), on the visited experts only. Both
    add the corrections in the same order and requantize h by 1/scale;
    the activation's float32 rounding may move an h across a bf16 boundary
    and so one requantized h by one int8 step, which moves an output by at
    most 127 * (its h scale) * (a down scale): well under 1% of the largest
    output here."""
    r, k = 8, 256
    d = experts_np(g=len(sizes), k=k, f=256, seed=7)
    xq, xst, eids, n_live = _buckets(sizes, k, r, seed=3)
    e = to_torch(d)
    got = TQ.fused_moe_prefill_i8(torch.from_numpy(xq), torch.from_numpy(xst),
                                  torch.from_numpy(eids), torch.tensor(n_live),
                                  e.gate, e.gate_s, e.up, e.up_s, e.down, e.down_s,
                                  capacity=r, activation=activation).numpy()
    je = to_jax(d)
    ref = np.asarray(JQ.fused_moe_prefill_i8(
        jnp.asarray(xq), jnp.asarray(xst), jnp.asarray(eids), jnp.asarray(n_live),
        je.gate, je.gate_s, je.up, je.up_s, je.down, je.down_s, capacity=r,
        activation=activation, interpret=True))
    live = eids[:n_live]
    np.testing.assert_allclose(got[live], ref[live], rtol=0,
                               atol=1e-2 * np.abs(ref[live]).max())


@pytest.mark.parametrize("sizes", [
    [5, 0, 9, 2, 0, 8],          # empty experts, uneven
    [24, 0, 0, 0, 0, 0],         # heavy skew: one expert overflows R
    [4, 4, 4, 4, 4, 4],          # uniform
])
def test_fused_prefill_try_matches_jax(sizes):
    """The whole fused prefill with its ragged overflow pass against the
    JAX package's ``_fused_prefill_try`` with the Pallas kernels in
    interpret mode; the same capacity, buckets and quantization points."""
    g, k = len(sizes), 256
    m = sum(sizes)
    d = experts_np(g=g, k=k, f=256, seed=7)
    rng = np.random.default_rng(31)
    xs = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    xs_b = torch.from_numpy(xs).to(torch.bfloat16)
    got = TM._fused_prefill_try(xs_b, torch.tensor(sizes, dtype=torch.int32),
                                to_torch(d), "silu", 0.0)
    ref = JM._fused_prefill_try(jnp.asarray(xs_b.float().numpy(), jnp.bfloat16),
                                jnp.asarray(sizes, jnp.int32), to_jax(d), "silu", 0.0,
                                interpret=True)
    assert got is not None and ref is not None
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_fused_rule_decides_by_shape():
    """The fused kernel takes the Qwen3-30B-A3B expert shape and leaves
    Mixtral-sized experts (FF 14336) to the ragged chain."""
    assert TQ.fused_prefill_fits(40, 2048, 768)
    assert TQ.fused_prefill_fits(512, 4096, 1280)
    assert not TQ.fused_prefill_fits(40, 4096, 14336)
    assert not TQ.fused_prefill_fits(36, 2048, 768)
    # a 64-row block: 4 ring stages of 32 KB (the down tile; two 8 KB weight
    # tiles and an 8 KB row tile in phase 1), beside the int8 h rows (64 x
    # 784 bytes), barriers, the item queue and alignment
    assert TQ.fused_smem_bytes(768) == 1176 + 64 * 784 + 4 * 32768


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("m,sizes", [(200, [64, 0, 3, 77, 1, 40, 0, 15]),
                                     (100, [0] * 8), (130, [33, 33, 30, 0, 0, 0, 0, 2])])
def test_ragged_kernel_matches_plain(m, sizes):
    k, n = 512, 320
    xq, xs, codes, sw = _ragged_case(m, k, n, len(sizes), seed=m)
    gs = torch.tensor(sizes, dtype=torch.int32).cuda()
    c, s = _torch_codes(codes, "cuda"), torch.from_numpy(sw).cuda()
    xq, xs = xq.cuda(), xs.cuda()
    got = TQ.ragged_qmatmul_i8(xq, xs.t(), c, s, gs)
    ref = TQ.ragged_qmatmul_i8_ref(xq, xs, c, s, gs)
    live = sum(sizes)
    torch.testing.assert_close(got[:live], ref[:live], rtol=1e-5, atol=1e-5)


@needs_cuda
@pytest.mark.parametrize("r,sizes", [
    (40, [40, 0, 17, 3, 0, 40, 8, 1]),
    (40, [0, 0, 5, 0, 0, 0, 0, 0]),            # a single live expert
    (40, [40, 12, 33, 1, 7, 40, 22, 9]),       # every slot live
    (96, [96, 0, 70, 3, 0, 65, 8, 1]),         # two row blocks (64 + 32 rows)
    (8, [8, 0, 3, 0, 0, 0, 1, 0]),             # one 16-row tile
])
def test_fused_kernel_matches_plain(r, sizes):
    """Kernel 9 against its plain version on the card: the same exact int32
    supergroup dots, corrections in supergroup order, activation, bf16
    rounding and requantization by 1/scale (torch's sigmoid and division
    round as the kernel does), so every live row equals the plain version
    bit for bit and repeats bit for bit."""
    k, f = 512, 768
    d = experts_np(g=len(sizes), k=k, f=f, seed=9)
    xq, xst, eids, n_live = _buckets(sizes, k, r, seed=5)
    e = to_torch(d, "cuda")
    args = (torch.from_numpy(xq).cuda(), torch.from_numpy(xst).cuda(),
            torch.from_numpy(eids).cuda(), torch.tensor(n_live).cuda(),
            e.gate, e.gate_s, e.up, e.up_s, e.down, e.down_s)
    got = TQ.fused_moe_prefill_i8(*args, capacity=r)
    again = TQ.fused_moe_prefill_i8(*args, capacity=r)
    ref = TQ.fused_moe_prefill_i8_ref(*args, capacity=r)
    live = torch.from_numpy(eids[:n_live]).long().cuda()
    assert torch.equal(got[live], ref[live])
    assert torch.equal(got[live], again[live])
