"""The port's single-kernel MoE decode (kernel 11) against the JAX package.

The plain version, which a CPU tensor runs, is held against the Pallas
kernel ``moe_decode_fused_i8`` in interpret mode and against the JAX oracle
``moe_decode_i8_ref``; the CUDA kernel is held against the plain version on
the card (skipped without one). Sizes follow the JAX package's own test:
K = FF = 256 and 512, 6 experts, top-3."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu.ops import moe_decode as JD
from ik_llama_cpp_tpu_torch.ops import moe as TM
from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

from test_torch_moe_decode import experts_np, to_jax, to_torch

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

G, K, FF, TOPK = 6, 512, 256, 3


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, K)) * 0.5).astype(np.float32)
    w = rng.random((t, TOPK)).astype(np.float32)
    idx = rng.integers(0, G, (t, TOPK)).astype(np.int32)
    return x, w, idx


def _fused_args(x, w, idx, wbf):
    """The quantized rows and the weight vector as ``moe_ffn`` hands them to
    the kernel (both packages make them the same way, bit for bit)."""
    xp = torch.from_numpy(np.repeat(x, TOPK, axis=0)).to(torch.bfloat16)
    wv = torch.from_numpy(w.reshape(-1))
    if wbf:
        xp = xp * wv[:, None].to(torch.bfloat16)
    xq, xs = t_quant(xp)
    wvec = torch.ones_like(wv) if wbf else wv
    return xq, xs, torch.from_numpy(idx.reshape(-1)), wvec


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("bias,wbf", [(False, False), (True, False), (False, True)])
def test_fused_plain_matches_jax_kernel(t, bias, wbf):
    """Kernel 11's function: the plain version against the Pallas kernel in
    interpret mode. Both add the supergroup corrections in the same order,
    round h to bf16 twice and requantize it by 1 / scale; the two sigmoids
    differ in the last float32 bits, which can move an h across a bf16
    boundary and its int8 code by one step of 1/127 of the supergroup's
    largest value: 1% of the largest output."""
    d = experts_np(g=G, k=K, f=FF, seed=t, bias=bias)
    x, w, idx = _inputs(t, 60 + t)
    act = "swiglu_oai" if bias else "silu"
    xq, xs, ids, wvec = _fused_args(x, w, idx, wbf)
    e, je = to_torch(d), to_jax(d)
    got = TD.moe_decode_fused_i8(xq, xs.t(), ids, wvec, e.gate, e.gate_s, e.up, e.up_s,
                                 e.down, e.down_s, e.gate_b, e.up_b, top_k=TOPK,
                                 activation=act).numpy()
    ref = JD.moe_decode_fused_i8(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()).T,
                                 jnp.asarray(ids.numpy()), jnp.asarray(wvec.numpy()),
                                 je.gate, je.gate_s, je.up, je.up_s, je.down, je.down_s,
                                 gate_b=je.gate_b, up_b=je.up_b, top_k=TOPK,
                                 activation=act, interpret=True)
    assert ref is not None and got.shape == (t, K)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("bias,wbf", [(False, False), (True, False), (False, True)])
def test_fused_decode_matches_jax_i8_ref(t, bias, wbf):
    """``moe_decode_i8(fused=True)``, down bias included, against the JAX
    oracle of the int8 decode (which requantizes h by division: one int8
    step at times, 1% of the largest output)."""
    d = experts_np(g=G, k=K, f=FF, seed=10 + t, bias=bias)
    x, w, idx = _inputs(t, 70 + t)
    act = "swiglu_oai" if bias else "silu"
    got = TD.moe_decode_i8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx),
                           to_torch(d), activation=act, weight_before_ffn=wbf,
                           fused=True).numpy()
    ref = np.asarray(JD.moe_decode_i8_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                          to_jax(d), activation=act, weight_before_ffn=wbf))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    two = TD.moe_decode_i8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx),
                           to_torch(d), activation=act, weight_before_ffn=wbf).numpy()
    np.testing.assert_allclose(got, two, rtol=0, atol=1e-2 * np.abs(two).max())


def test_requant_by_inverse_matches_jax_kernel_arithmetic():
    """amax / 127 as a float32 division, 1 / scale, round(h * inv) to
    nearest even, clip: the requantization of the Pallas kernel's body,
    and zero rows stay zero."""
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((7, 512)) * 3).astype(np.float32)
    h[2] = 0.0
    hb = jnp.asarray(h, jnp.bfloat16).astype(jnp.float32)
    hg = hb.reshape(7, 2, 256)
    sc = jnp.max(jnp.abs(hg), axis=2, keepdims=True) / 127.0
    inv = jnp.where(sc > 0, 1.0 / jnp.where(sc > 0, sc, 1.0), 0.0)
    jq = jnp.clip(jnp.round(hg * inv), -127, 127).astype(jnp.int8).reshape(7, 512)
    tq, ts = TD.requant_by_inverse(torch.from_numpy(h).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(sc[..., 0]))


def test_shape_rule():
    """The kernel's own rule takes the place of the TPU's VMEM budget:
    supergroup K and FF, and a token's requantized rows in one block's
    shared memory."""
    assert TD.fused_decode_fits(2048, 768, 8)
    assert TD.fused_decode_fits(4096, 14336, 2)       # the TPU kernel declines this one
    assert not TD.fused_decode_fits(320, 256, 2)      # K not a multiple of 256
    assert not TD.fused_decode_fits(2048, 1408, 4)    # FF not a multiple of 256
    # h is read from L2, so 8 rows of 32 KB fit; the down scales and sums of
    # 64 pairs over 128 supergroups do not
    assert TD.fused_decode_fits(2048, 32768, 8)
    assert not TD.fused_decode_fits(2048, 32768, 64)
    # the activation row and its scales outweigh phase 2's scales and sums
    assert TD.fused_decode_smem_bytes(2048, 768, 8) == 2048 + 8 * 4


@pytest.mark.parametrize("fits", [True, False])
def test_moe_ffn_takes_the_fused_kernel_only_when_asked_and_fitting(monkeypatch, fits):
    """IK_MOE_FUSED_TG=1 is read at call time; where the shape rule
    declines, ``moe_ffn`` runs the two-kernel chain without calling the
    fused wrapper."""
    d = experts_np(g=G, k=K, f=FF, seed=3)
    x, _, _ = _inputs(2, 80)
    logits = np.random.default_rng(8).standard_normal((2, G)).astype(np.float32)
    calls = []
    real = TD.moe_decode_fused_i8

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TD, "moe_decode_fused_i8", spy)
    args = (torch.from_numpy(x), torch.from_numpy(logits), to_torch(d), TOPK)
    base = TM.moe_ffn(*args).numpy()
    assert not calls
    monkeypatch.setenv("IK_MOE_FUSED_TG", "1")
    if not fits:
        monkeypatch.setattr(TM, "fused_decode_fits", lambda *a: False)
    got = TM.moe_ffn(*args).numpy()
    assert bool(calls) == fits
    np.testing.assert_allclose(got, base, rtol=0, atol=1e-2 * np.abs(base).max())
    ref = np.asarray(JM.moe_ffn(jnp.asarray(x), jnp.asarray(logits), to_jax(d), TOPK))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


# ------------------------------------------------------------------ card --
@needs_cuda
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_kernel_matches_plain(t, bias):
    """Kernel 11 against its plain version on the card: the same integer
    dots, corrections, roundings and requantization in the same order
    (torch's sigmoid and division round as the kernel does), so the
    result equals the plain version bit for bit and repeats bit for bit;
    T = 3 gives P = 24 pairs, not a power of two."""
    d = experts_np(g=16, k=1024, f=768, seed=t, bias=bias)
    e = to_torch(d, "cuda")
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((t * 8, 1024)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, 16, t * 8).astype(np.int32)).cuda()
    wts = torch.from_numpy(rng.random(t * 8).astype(np.float32)).cuda()
    xq, xs = t_quant(x)
    a = (xq, xs.t(), ids, wts, e.gate, e.gate_s, e.up, e.up_s, e.down, e.down_s,
         e.gate_b, e.up_b)
    got = TD.moe_decode_fused_i8(*a, top_k=8)
    again = TD.moe_decode_fused_i8(*a, top_k=8)
    ref = TD.moe_decode_fused_i8_ref(*a, top_k=8)
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
