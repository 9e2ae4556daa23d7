"""The port's MoE decode chain (kernels 7 and 8) against the JAX package.

The plain versions, which a CPU tensor runs, are held against the Pallas
kernels in interpret mode and against the JAX oracle ``moe_decode_i8_ref``;
the CUDA kernels are held against the plain versions on the card (skipped
without one). Shapes are small: K 512, FF 256, 8 experts, top-2."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu.ops import moe_decode as JD
from ik_llama_cpp_tpu.ops.qmatmul import quantize_activations as j_quant
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

G, K, FF, TOPK = 8, 512, 256, 2
BF16_ULP = 2.0 ** -8


def experts_np(g=G, k=K, f=FF, seed=0, bias=False):
    """Supergroup experts as numpy: codes (G, K, N) int8, positive f32
    (G, K/256, N) scales, optional f32 biases."""
    rng = np.random.default_rng(seed)

    def q(kk, nn):
        codes = rng.integers(-127, 128, (g, kk, nn), dtype=np.int8)
        sw = (np.abs(rng.standard_normal((g, kk // 256, nn))) * 0.02 + 1e-4).astype(np.float32)
        return codes, sw

    d = {}
    for name, (kk, nn) in (("gate", (k, f)), ("up", (k, f)), ("down", (f, k))):
        d[name], d[name + "_s"] = q(kk, nn)
        d[name + "_b"] = (rng.standard_normal((g, nn)).astype(np.float32)
                          if bias else None)
    return d


def to_jax(d):
    opt = {n + "_b": None if d[n + "_b"] is None else jnp.asarray(d[n + "_b"])
           for n in ("gate", "up", "down")}
    return JM.QuantExpertWeights(
        *(jnp.asarray(d[n]) for n in ("gate", "gate_s", "up", "up_s", "down", "down_s")),
        gate_group=256, up_group=256, down_group=256, **opt)


def to_torch(d, device="cpu"):
    """Codes stored (G, N, K) and held as the (G, K, N) view, as the loader does."""
    kw = {}
    for n in ("gate", "up", "down"):
        kw[n] = torch.from_numpy(d[n].transpose(0, 2, 1).copy()).to(device).transpose(1, 2)
        kw[n + "_s"] = torch.from_numpy(d[n + "_s"]).to(device)
        kw[n + "_b"] = None if d[n + "_b"] is None else torch.from_numpy(d[n + "_b"]).to(device)
    return TM.QuantExpertWeights(**kw)


def pairs(t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, K)) * 0.5).astype(np.float32)
    w = rng.random((t, TOPK)).astype(np.float32)
    idx = np.stack([rng.choice(G, TOPK, replace=False) for _ in range(t)]).astype(np.int32)
    return x, w, idx


@pytest.mark.parametrize("activation,limit", [("silu", 0.0), ("silu", 0.7),
                                              ("swiglu_oai", 0.0), ("gelu", 0.0)])
def test_act_matches_jax(activation, limit):
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((64, 96)) * 4).astype(np.float32)
    u = (rng.standard_normal((64, 96)) * 4).astype(np.float32)
    got = TD._act(torch.from_numpy(g), torch.from_numpy(u), activation, limit).numpy()
    ref = np.asarray(JD._act(jnp.asarray(g), jnp.asarray(u), activation, limit))
    # float32 transcendental implementations differ by a few ulps
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("bias", [False, True])
def test_gate_up_plain_matches_jax_kernel(t, bias):
    """Kernel 7's function: the plain version against the Pallas kernel in
    interpret mode. Both add the supergroup corrections in the same order,
    so h agrees to one bf16 ulp (the sigmoid's float32 rounding can move a
    value across a bf16 rounding boundary)."""
    d = experts_np(seed=t, bias=bias)
    x, _, idx = pairs(t, seed=10 + t)
    xp = np.repeat(x, TOPK, axis=0)
    xq, xs = t_quant(torch.from_numpy(xp).to(torch.bfloat16))
    ids = torch.from_numpy(idx.reshape(-1))
    e = to_torch(d)
    got = TD.moe_decode_gate_up_i8(xq, xs.t(), ids, e.gate, e.gate_s, e.up, e.up_s,
                                   e.gate_b, e.up_b).float().numpy()
    je = to_jax(d)
    ref = JD.moe_decode_gate_up_i8(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()).T,
                                   jnp.asarray(idx.reshape(-1)), je.gate, je.gate_s,
                                   je.up, je.up_s, gate_b=je.gate_b, up_b=je.up_b,
                                   interpret=True)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-30)


@pytest.mark.parametrize("t,topk,e,repeat", [
    pytest.param(1, TOPK, K, False, id="1"), pytest.param(4, TOPK, K, False, id="4"),
    pytest.param(2, 1, K, False, id="topk1"),               # one pair a token
    pytest.param(1, 8, 204, False, id="e204"),              # E off the kernel's column tile
    pytest.param(8, 4, 100, True, id="t8-repeats")])        # experts repeated in and across tokens
def test_down_plain_matches_jax_kernel(t, topk, e, repeat):
    """Kernel 8's function: the plain version against the Pallas kernel in
    interpret mode; the same exact integer dots summed pair by pair in the
    same order."""
    rng = np.random.default_rng(t)
    if (topk, e) == (TOPK, K):
        d = experts_np(seed=20 + t)
        _, _, idx = pairs(t, seed=30 + t)
        down, down_s = d["down"], d["down_s"]
    else:
        down = rng.integers(-127, 128, (G, FF, e), dtype=np.int8)
        down_s = (np.abs(rng.standard_normal((G, FF // 256, e))) * 0.02 + 1e-4).astype(np.float32)
        idx = rng.integers(0, G, (t, topk)).astype(np.int32)
        if repeat:
            idx[:, 1] = idx[:, 0]
            idx[-1] = idx[0]
    h = rng.standard_normal((t * topk, FF)).astype(np.float32)
    hq, hs = t_quant(torch.from_numpy(h).to(torch.bfloat16))
    codes = torch.from_numpy(down.transpose(0, 2, 1).copy()).transpose(1, 2)
    got = TD.moe_decode_down_i8(hq, hs.t(), torch.from_numpy(idx.reshape(-1)),
                                codes, torch.from_numpy(down_s), top_k=topk).numpy()
    ref = np.asarray(JD.moe_decode_down_i8(
        jnp.asarray(hq.numpy()), jnp.asarray(hs.numpy()).T, jnp.asarray(idx.reshape(-1)),
        jnp.asarray(down), jnp.asarray(down_s), top_k=topk, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_quantize_points_match_jax():
    """The port quantizes the repeated rows exactly as the JAX package."""
    x, _, _ = pairs(4, seed=3)
    xp = np.repeat(x, TOPK, axis=0)
    tq, ts = t_quant(torch.from_numpy(xp).to(torch.bfloat16))
    jq, js = j_quant(jnp.asarray(xp, jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("bias", [False, True])
def test_decode_ref_matches_jax_ref(t, bias):
    """The whole decode FFN: the port's moe_decode_i8_ref against the JAX
    oracle. The JAX oracle sums each supergroup's correction in another
    order (one einsum), so h can differ by one bf16 ulp and the requantized
    h by one int8 step of its supergroup; 1% of the largest output covers
    that and nothing more."""
    d = experts_np(seed=40 + t, bias=bias)
    x, w, idx = pairs(t, seed=50 + t)
    act = "swiglu_oai" if bias else "silu"
    got = TD.moe_decode_i8_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(idx), to_torch(d), activation=act).numpy()
    ref = np.asarray(JD.moe_decode_i8_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                          to_jax(d), activation=act))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("bias", [False, True])
def test_decode_kernels_match_plain(t, bias):
    """Kernels 7 and 8 against their plain versions on the card: h within
    one bf16 ulp, the down sum bit for bit up to float32 reassociation."""
    d = experts_np(g=16, k=1024, f=768, seed=t, bias=bias)
    e = to_torch(d, "cuda")
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((t * 8, 1024)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, 16, t * 8).astype(np.int32)).cuda()
    xq, xs = t_quant(x)
    h = TD.moe_decode_gate_up_i8(xq, xs.t(), ids, e.gate, e.gate_s, e.up, e.up_s,
                                 e.gate_b, e.up_b, activation="silu")
    hr = TD.moe_decode_gate_up_i8_ref(xq, xs.t(), ids, e.gate, e.gate_s, e.up, e.up_s,
                                      e.gate_b, e.up_b, activation="silu")
    torch.testing.assert_close(h.float(), hr.float(), rtol=BF16_ULP, atol=0)
    hq, hs = t_quant(hr)
    out = TD.moe_decode_down_i8(hq, hs.t(), ids, e.down, e.down_s, top_k=8)
    ref = TD.moe_decode_down_i8_ref(hq, hs.t(), ids, e.down, e.down_s, top_k=8)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
