"""The port's attention and elementwise layers against the JAX package.

The plain attention (what a CPU tensor runs for both flash-attention
wrappers) is held against the Pallas kernels in interpret mode and against
``attend``, at one bf16 ulp of the output: both sides take bf16 inputs,
compute in float32 and round once to bf16, so a different summation order
can move a result by at most one rounding step. The CUDA kernels are held
against the plain version on the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import layers as JL
from ik_llama_cpp_tpu.ops.attention import attend as j_attend
from ik_llama_cpp_tpu.ops.flash_attention import (
    flash_attention as j_fa, flash_attention_decode as j_fa_dec)
from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA
from ik_llama_cpp_tpu_torch.ops import layers as TL

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 rounding step at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_ulp(got, ref):
    """One bf16 ulp at each element; a result that cancels to near zero gets
    the float32 rounding of the output's scale (2^-20 max|ref|) instead."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = np.maximum(bf16_ulp(np.maximum(np.abs(got), np.abs(ref))),
                     2.0 ** -20 * np.abs(ref).max())
    bad = np.abs(got - ref) > tol
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond one bf16 ulp; "
                           f"max diff {np.abs(got - ref).max():.3e}")


def make(b, t, s, h, hkv, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv or d)).astype(np.float32)
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jq = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    return tq, jq


def run_both(fn_t, tq, jq, qpos, kvlen, t, j_kernel=None, **kw):
    got = fn_t(*tq, torch.tensor(qpos, dtype=torch.int32),
               torch.tensor(kvlen, dtype=torch.int32), **kw).float().numpy()
    b = len(qpos)
    q_pos = np.asarray(qpos, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]
    sinks = kw.pop("sinks", None)
    jsinks = None if sinks is None else jnp.asarray(sinks.numpy())
    ref = j_attend(*jq, q_pos=jnp.asarray(q_pos), kv_len=jnp.asarray(kvlen, jnp.int32),
                   sinks=jsinks, **kw)
    assert_within_ulp(got, ref)
    if j_kernel is not None:
        ker = j_kernel(*jq, jnp.asarray(qpos, jnp.int32), jnp.asarray(kvlen, jnp.int32),
                       sinks=jsinks, **kw)
        assert_within_ulp(got, ker)
    assert b == got.shape[0]


PREFILL = {
    # b, t, s, h, hkv, d, q_pos0, kv_len, extra, also against the Pallas
    # kernel (interpret mode costs seconds a case, so a covering subset)
    "gqa": (1, 16, 64, 4, 2, 64, [0], [16], {}, False),
    "continuation": (1, 16, 96, 4, 1, 64, [40], [56], {}, False),
    "batch_rows": (2, 16, 64, 4, 2, 64, [0, 20], [16, 36], {}, True),
    "softcap": (1, 16, 96, 4, 2, 64, [40], [56], {"softcap": 5.0}, False),
    "swa": (1, 16, 96, 4, 2, 64, [40], [56], {"swa_window": 24}, True),
    "chunk": (1, 32, 96, 4, 2, 64, [16], [48], {"attn_chunk": 32}, False),
    "sinks": (1, 16, 64, 4, 2, 64, [48], [64], {"sinks": True, "softcap": 5.0}, True),
}


def _kw(extra, h, d, seed):
    kw = dict(extra, scale=1.0 / float(np.sqrt(d)))
    if kw.get("sinks"):
        kw["sinks"] = torch.from_numpy(
            np.random.default_rng(seed).normal(size=h).astype(np.float32))
    return kw


@pytest.mark.parametrize("case", list(PREFILL))
def test_prefill_plain_matches_jax(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, pallas = PREFILL[case]
    tq, jq = make(b, t, s, h, hkv, d, seed=len(case))

    def j_kernel(*a, **kw):
        return j_fa(*a, block_q=16, block_kv=32, interpret=True, **kw)

    run_both(TFA.flash_attention, tq, jq, qpos, kvlen, t,
             j_kernel if pallas else None, **_kw(extra, h, d, len(case)))


DECODE = {
    # b, t, s, h, hkv, d, q_pos0, kv_len, extra, also against the Pallas
    # kernel (a subset of the shapes it takes: S % 128 == 0, D == 128)
    "step": (1, 1, 128, 8, 2, 128, [63], [64], {}, False),
    "verify_t8": (1, 8, 256, 8, 2, 128, [40], [48], {}, True),
    "batch_rows": (2, 1, 256, 4, 4, 128, [100, 200], [101, 201], {}, True),
    "softcap": (1, 2, 128, 4, 1, 128, [50], [52], {"softcap": 5.0}, False),
    "swa": (1, 1, 256, 8, 2, 128, [200], [201], {"swa_window": 64}, False),
    "chunk": (1, 1, 256, 8, 2, 128, [140], [141], {"attn_chunk": 64}, False),
    "sinks": (1, 1, 256, 8, 2, 128, [140], [141], {"sinks": True, "swa_window": 100}, True),
    "odd_capacity": (1, 4, 200, 6, 2, 80, [150], [154], {}, False),
    "head_dim_40": (2, 1, 96, 4, 2, 40, [10, 60], [11, 61], {}, False),
}


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_plain_matches_jax(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, tpu_ok = DECODE[case]
    tq, jq = make(b, t, s, h, hkv, d, seed=10 + len(case))

    def j_kernel(*a, **kw):
        out = j_fa_dec(*a, block_kv=128, interpret=True, **kw)
        assert out is not None
        return out

    run_both(TFA.flash_attention_decode, tq, jq, qpos, kvlen, t,
             j_kernel if tpu_ok else None, **_kw(extra, h, d, len(case)))


def test_plain_attention_takes_views_of_a_stacked_cache():
    """The model passes kv.k[i], a view of (L, B, S, Hkv, D)."""
    (q, k, v), _ = make(1, 1, 64, 4, 2, 32, seed=3)
    stack_k = torch.stack([torch.zeros_like(k), k])
    stack_v = torch.stack([torch.zeros_like(v), v])
    a = TFA.flash_attention_decode(q, stack_k[1], stack_v[1], 30, 31, scale=0.2)
    b = TFA.flash_attention_decode(q, k, v, 30, 31, scale=0.2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- layers --
def test_rms_norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    w = np.random.default_rng(1).uniform(0.5, 1.5, 64).astype(np.float32)
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TL.rms_norm(torch.from_numpy(x).to(dt_t), torch.from_numpy(w), 1e-5)
        ref = JL.rms_norm(jnp.asarray(x, dt_j), jnp.asarray(w), 1e-5)
        if dt_t is torch.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        else:
            assert_within_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("rope_type,scaling,rot", [
    (TL.ROPE_TYPE_NORM, "none", 64), (TL.ROPE_TYPE_NEOX, "linear", 64),
    (TL.ROPE_TYPE_NORM, "yarn", 64), (TL.ROPE_TYPE_NEOX, "yarn", 32)])
def test_rope_matches_jax(rope_type, scaling, rot):
    pos = np.arange(40, 60, dtype=np.int32)[None].repeat(2, 0)
    kw = {}
    if scaling == "linear":
        kw = dict(freq_scale=0.25)
    elif scaling == "yarn":
        kw = dict(freq_scale=0.25, ext_factor=1.0, attn_factor=1.0, n_ctx_orig=4096)
    ct, st = TL.rope_cache(torch.from_numpy(pos), rot, 10000.0, **kw)
    cj, sj = JL.rope_cache(jnp.asarray(pos), rot, 10000.0, **kw)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(2).standard_normal((2, 20, 3, 64)).astype(np.float32)
    got = TL.apply_rope(torch.from_numpy(x), ct, st, rope_type)
    ref = JL.apply_rope(jnp.asarray(x), cj, sj, rope_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2", "swiglu_oai"])
def test_glu_matches_jax(act):
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((4, 96)) * 3).astype(np.float32)
    u = rng.standard_normal((4, 96)).astype(np.float32)
    got = TL.glu(torch.from_numpy(g), torch.from_numpy(u), act)
    ref = JL.glu(jnp.asarray(g), jnp.asarray(u), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ card --
def _card_case(b, t, s, h, hkv, d, qpos, kvlen, seed, extra=None, dv=None):
    (q, k, v), _ = make(b, t, s, h, hkv, d, seed, dv)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    kw = _kw(extra or {}, h, d, seed)
    if "sinks" in kw:
        kw["sinks"] = kw["sinks"].cuda()
    qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
    return (q, k, v, qp, kl), kw


@needs_cuda
@pytest.mark.parametrize("case", list(PREFILL))
def test_prefill_kernel_matches_plain(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, _ = PREFILL[case]
    args, kw = _card_case(b, t, s, h, hkv, d, qpos, kvlen, 1, extra)
    got = TFA.flash_attention(*args, **kw).float()
    ref = TFA.attention_ref(*args, **kw).float()
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@needs_cuda
@pytest.mark.parametrize("case", list(DECODE))
def test_decode_kernel_matches_plain(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, _ = DECODE[case]
    args, kw = _card_case(b, t, s, h, hkv, d, qpos, kvlen, 2, extra)
    got = TFA.flash_attention_decode(*args, **kw).float()
    ref = TFA.attention_ref(*args, **kw).float()
    assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


# b, t, s, h, hkv, dk, dv, q_pos0, kv_len, extra: the prefill kernel at
# the models' head layouts (32/8 dense, 32/4 Qwen3-30B-A3B, 16/16
# Qwen1.5-MoE-A2.7B), head dims 64-256 and Dk != Dv (72/40: not whole
# 16-column fragments), T that is not a whole 64-row tile, q_pos0 > 0 with
# kv_len inside a key tile, rows that see fewer keys than their position,
# and the masks over several key tiles
CARD_PREFILL = {
    "t17_d128_32x8": (1, 17, 64, 32, 8, 128, None, [0], [17], {}),
    "t64_d64_16x16": (1, 64, 128, 16, 16, 64, None, [0], [64], {}),
    "t100_d256_32x4": (1, 100, 256, 32, 4, 256, None, [30], [130], {}),
    "t512_d128_32x8": (1, 512, 1024, 32, 8, 128, None, [0], [512], {}),
    "t512_d128_32x4_cont": (1, 512, 1024, 32, 4, 128, None, [256], [768], {}),
    "t512_d128_16x16": (1, 512, 1024, 16, 16, 128, None, [0], [512], {}),
    "dk192_dv128": (1, 100, 256, 8, 2, 192, 128, [37], [137], {}),
    "dk128_dv64": (1, 64, 192, 8, 2, 128, 64, [70], [134], {}),
    "dk72_dv40": (1, 64, 160, 8, 4, 72, 40, [10], [74], {}),
    "batch_across_tiles": (2, 100, 320, 8, 2, 128, None, [50, 121], [150, 221], {}),
    "kv_shorter_than_pos": (1, 64, 256, 8, 2, 128, None, [100], [80], {}),
    "softcap": (1, 128, 256, 8, 2, 128, None, [64], [192], {"softcap": 30.0}),
    "swa": (1, 256, 512, 8, 2, 128, None, [100], [356], {"swa_window": 100}),
    "chunk": (1, 200, 512, 8, 2, 128, None, [40], [240], {"attn_chunk": 64}),
    "sinks": (1, 128, 256, 8, 2, 64, None, [60], [188],
              {"sinks": True, "softcap": 20.0, "swa_window": 90}),
    "d256_swa_chunk": (1, 96, 256, 4, 2, 256, None, [100], [196],
                       {"swa_window": 50, "attn_chunk": 128}),
}


@needs_cuda
@pytest.mark.parametrize("case", list(CARD_PREFILL))
def test_prefill_kernel_at_model_shapes(case):
    b, t, s, h, hkv, d, dv, qpos, kvlen, extra = CARD_PREFILL[case]
    args, kw = _card_case(b, t, s, h, hkv, d, qpos, kvlen, 3, extra, dv)
    got = TFA.flash_attention(*args, **kw).float()
    ref = TFA.attention_ref(*args, **kw).float()
    assert got.shape == ref.shape
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
