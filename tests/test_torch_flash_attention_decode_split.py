"""Kernel C, the split-K decode attention (``csrc/flash_attention_decode.cu``):
its split plan and key ranges, and a plain model of its partition and
merge, held against the JAX package's Pallas decode kernel (interpret
mode, as tests/test_flash_attention.py runs it) and the port's plain
version on the CPU; the kernel itself against the plain version on the
card (skipped without one).

Tolerances:
- the model with unrounded probabilities against the plain version in
  float32: 1e-5 max|ref|; the two take the same exact scores, and differ
  only in the order of their float32 sums and in the rescaling of partial
  sums by exp(m_split - m);
- the model (probabilities rounded to bf16 before the PV product, as the
  kernel does) and the kernel against bf16 results: 2^-7 max|ref|, phase
  3's rule. A probability rounded to bf16 moves by up to 2^-9 of itself
  while the row sum keeps it unrounded, and the output is rounded to bf16:
  two bf16 ulps at the largest output."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops.flash_attention import flash_attention_decode as j_fa_dec
from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")

FA_NEG = -1e30
KT = TFA.DECODE_KT


def first_key(qpos, swa, chunk):
    start = 0
    if swa > 0:
        start = max(start, qpos - swa + 1)
    if chunk > 0:
        start = max(start, (qpos // chunk) * chunk)
    return start


def allowed(keys, qp, kv_len, swa, chunk):
    ok = (keys[None, :] <= qp[:, None]) & (keys[None, :] < kv_len)
    if swa > 0:
        ok &= keys[None, :] > qp[:, None] - swa
    if chunk > 0:
        ok &= keys[None, :] >= (qp[:, None] // chunk) * chunk
    return ok


def split_model(q, k, v, q_pos0, kv_len, *, scale, softcap=0.0, swa_window=0,
                attn_chunk=0, sinks=None, sms=_cuda.DEFAULT_SMS, round_p=True):
    """The kernel's arithmetic in float32 torch on the CPU. For each
    (batch, kv head) group: the blocks' key ranges of ``decode_key_ranges``;
    inside a range, warp w of the ``ksplit`` warps takes the 32-key tiles
    lo + 32w, lo + 32w + round, ... with its own online softmax (scale, then
    softcap, then mask; p rounded to bf16 for the PV product where
    ``round_p``); a block merges its warps in warp order. One range: the
    block's merge takes the sinks and gives the output. Several: each block
    leaves (m, l, o), merged in split order with the sinks."""
    b, t, h, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    plan = TFA.decode_split_plan(b, t, h, hkv, s, dk, dv, sms)
    rep = h // hkv
    rows = rep * t
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, t, h, dv))
    tok = torch.arange(rows) % t
    head_in = torch.arange(rows) // t
    for bi in range(b):
        qpos, kl = int(q_pos0[bi]), int(kv_len[bi])
        key_end = min(kl, qpos + t)
        key_start = first_key(qpos, swa_window, attn_chunk)
        qp = qpos + tok
        ranges = TFA.decode_key_ranges(plan, key_start, key_end)
        for hk in range(hkv):
            heads = hk * rep + head_in
            qr = qf[bi, tok, heads]                       # (rows, dk)
            states = []
            for lo, hi in ranges:
                warps = []
                for w in range(plan["ksplit"]):
                    m = torch.full((rows,), FA_NEG)
                    l = torch.zeros(rows)
                    o = torch.zeros((rows, dv))
                    for key0 in range(lo + w * KT, hi, plan["round"]):
                        keys = torch.arange(key0, key0 + KT)
                        live = keys < key_end
                        kt = torch.where(live[:, None], kf[bi, keys.clamp(max=s - 1), hk], 0.0)
                        vt = torch.where(live[:, None], vf[bi, keys.clamp(max=s - 1), hk], 0.0)
                        sc = (qr @ kt.T) * scale
                        if softcap > 0:
                            sc = softcap * torch.tanh(sc / softcap)
                        ok = allowed(keys, qp, kl, swa_window, attn_chunk)
                        mx = torch.maximum(m, torch.where(ok, sc, FA_NEG).amax(1))
                        alpha = torch.exp(m - mx)
                        p = torch.where(ok, torch.exp(sc - mx[:, None]), 0.0)
                        l = l * alpha + p.sum(1)
                        pv = p.to(torch.bfloat16).float() if round_p else p
                        o = o * alpha[:, None] + pv @ vt
                        m = mx
                    warps.append((m, l, o))
                states.append(merge(warps))
            sk = None if sinks is None else sinks[heads].float()
            if len(ranges) == 1:     # block 0 merges its warps with the sinks
                mm, l, o = merge(warps, sk)
            else:
                mm, l, o = merge(states, sk)
            res = o / torch.where(l > 0, l, torch.ones_like(l))[:, None]
            out[bi, tok, heads] = res
    return out


def merge(states, sinks=None):
    """(m, l, o) states merged in order: m the max (and the sinks'), l and o
    rescaled by exp(m_i - m) and summed; the sinks add exp(sink - m) to l."""
    mm = states[0][0]
    for m, _, _ in states[1:]:
        mm = torch.maximum(mm, m)
    if sinks is not None:
        mm = torch.maximum(mm, sinks)
    l = torch.zeros_like(states[0][1])
    o = torch.zeros_like(states[0][2])
    for m, li, oi in states:
        f = torch.exp(m - mm)
        l = l + li * f
        o = o + oi * f[:, None]
    if sinks is not None:
        l = l + torch.exp(sinks - mm)
    return mm, l, o


def make(b, t, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]


def _kw(extra, h, seed, d):
    kw = dict(extra, scale=1.0 / float(np.sqrt(d)))
    if kw.get("sinks"):
        kw["sinks"] = torch.from_numpy(
            np.random.default_rng(seed).normal(size=h).astype(np.float32))
    return kw


# ------------------------------------------------------------- the plan --
@pytest.mark.parametrize("b,t,h,hkv,s,d", [
    (1, 1, 32, 8, 4096, 128), (1, 8, 32, 8, 4096, 128), (1, 16, 32, 8, 1024, 128),
    (1, 1, 32, 4, 4096, 128), (1, 1, 16, 16, 1024, 128), (2, 1, 32, 8, 1024, 128),
    (8, 4, 32, 8, 4096, 128), (1, 1, 8, 2, 256, 256), (1, 16, 64, 8, 512, 64),
    (1, 1, 8, 2, 96, 40)])
def test_decode_split_plan(b, t, h, hkv, s, d):
    """The plan mirrors the kernel's row tiles (16 rows an m-tile, up to
    the block's warps of them) and warps (8, 4 above head dim 128), splits
    by S and the SM count only, and gives about one block an SM."""
    plan = TFA.decode_split_plan(b, t, h, hkv, s, d, d)
    rows = (h // hkv) * t
    assert plan["warps"] == (8 if d <= 128 else 4)
    assert plan["rows"] % 16 == 0 and plan["rows"] // 16 <= plan["warps"]
    assert plan["row_groups"] * plan["rows"] >= rows > (plan["row_groups"] - 1) * plan["rows"]
    assert plan["ksplit"] * plan["rows"] // 16 == plan["warps"]
    assert plan["round"] == plan["ksplit"] * KT
    assert plan["groups"] == b * hkv * plan["row_groups"]
    assert 1 <= plan["splits"] <= TFA.DECODE_MAX_SPLITS
    assert plan["splits"] <= -(-s // plan["round"])
    assert (plan["splits"] - 1) * plan["groups"] < _cuda.DEFAULT_SMS


def test_decode_split_plan_at_the_measured_shapes():
    """The dense model's decode step (32/8 heads, T 1) at S 4096 splits 16
    ways (128 blocks), at S 1024 4 ways; T 8 (32 rows, two m-tiles a block)
    17 ways; a batch of 32 groups or more gives one block a group."""
    assert TFA.decode_split_plan(1, 1, 32, 8, 4096, 128, 128)["splits"] == 16
    assert TFA.decode_split_plan(1, 1, 32, 8, 1024, 128, 128)["splits"] == 4
    assert TFA.decode_split_plan(1, 8, 32, 8, 4096, 128, 128)["splits"] == 17
    assert TFA.decode_split_plan(32, 1, 32, 8, 4096, 128, 128)["splits"] == 1


def test_decode_split_plan_refuses_long_chunks():
    with pytest.raises(ValueError):
        TFA.decode_split_plan(1, 17, 32, 8, 4096, 128, 128)


@pytest.mark.parametrize("splits", [1, 3, 4, 16, 32])
@pytest.mark.parametrize("rnd", [128, 256])
@pytest.mark.parametrize("start,end", [(0, 0), (0, 1), (0, 255), (0, 256), (0, 257),
                                       (0, 513), (100, 1000), (3, 4000), (640, 1000)])
def test_decode_key_ranges_cover_the_live_keys_once(start, end, rnd, splits):
    """The ranges cover [key_start, key_end) once, in order; one range
    where the keys fit one round or there is one split; otherwise at most
    ``splits`` ranges, each but the last a whole number of 32-key tiles
    and at least one round, so no tile crosses into the next range."""
    plan = {"splits": splits, "round": rnd}
    ranges = TFA.decode_key_ranges(plan, start, end)
    assert ranges[0][0] == start and ranges[-1][1] == end
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    if splits == 1 or end - start <= rnd:
        assert len(ranges) == 1
        return
    assert 1 < len(ranges) <= splits
    for lo, hi in ranges[:-1]:
        assert (hi - lo) % KT == 0 and hi - lo >= rnd
    assert 0 < ranges[-1][1] - ranges[-1][0] <= ranges[0][1] - ranges[0][0]


# ------------------------------------------------ the partition and merge --
# b, t, s, h, hkv, d, q_pos0, kv_len, extra: kv_len 1 to 1000 over S 1024
# (the plan splits the 32/8 layout 4 ways at T 1, 8 ways at T 8), across
# every split boundary of a round (255, 256, 257), with the masks
CASES = {
    "kv1": (1, 1, 1024, 8, 2, 128, [0], [1], {}),
    "kv255": (1, 1, 1024, 8, 2, 128, [254], [255], {}),
    "kv256": (1, 1, 1024, 8, 2, 128, [255], [256], {}),
    "kv257": (1, 1, 1024, 8, 2, 128, [256], [257], {}),
    "kv513": (1, 1, 1024, 8, 2, 128, [512], [513], {}),
    "kv1000": (1, 1, 1024, 8, 2, 128, [999], [1000], {}),
    "swa": (1, 1, 1024, 8, 2, 128, [999], [1000], {"swa_window": 300}),
    "chunk": (1, 1, 1024, 8, 2, 128, [999], [1000], {"attn_chunk": 384}),
    "softcap_sinks": (1, 1, 1024, 8, 2, 128, [700], [701], {"softcap": 5.0, "sinks": True}),
    "t8": (1, 8, 1024, 8, 2, 128, [505], [513], {}),
    "t8_b2_sinks_swa": (2, 8, 1024, 8, 2, 128, [249, 992], [257, 1000],
                        {"sinks": True, "swa_window": 400}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_model_matches_jax_and_plain(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra = CASES[case]
    q, k, v = make(b, t, s, h, hkv, d, seed=len(case) + 20)
    kw = _kw(extra, h, 7, d)
    qp, kl = torch.tensor(qpos, dtype=torch.int32), torch.tensor(kvlen, dtype=torch.int32)
    plan = TFA.decode_split_plan(b, t, h, hkv, s, d, d)
    if case in ("kv257", "kv513", "kv1000", "t8"):
        assert len(TFA.decode_key_ranges(plan, 0, kvlen[0])) > 1, "no split"
    # the algebra: unrounded probabilities against the plain version in float32
    exact = split_model(q, k, v, qp, kl, round_p=False, **kw)
    ref32 = TFA.attention_ref(q.float(), k.float(), v.float(), qp, kl, **kw)
    assert float((exact - ref32).abs().max()) <= 1e-5 * float(ref32.abs().max())
    # the kernel's rounding against the bf16 plain version and the Pallas kernel
    got = split_model(q, k, v, qp, kl, **kw)
    ref = TFA.attention_ref(q, k, v, qp, kl, **kw).float()
    sinks = kw.pop("sinks", None)
    jax_out = j_fa_dec(*[jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)],
                       jnp.asarray(qpos, jnp.int32), jnp.asarray(kvlen, jnp.int32),
                       sinks=None if sinks is None else jnp.asarray(sinks.numpy()),
                       block_kv=128, interpret=True, **kw)
    jax_out = torch.from_numpy(np.asarray(jax_out, np.float32))
    for r in (ref, jax_out):
        assert float((got - r).abs().max()) <= 2.0 ** -7 * float(r.abs().max())


def test_split_model_with_one_split_is_the_first_port():
    """A card of few SMs gets one split: one range, every tile a warp's."""
    q, k, v = make(1, 1, 1024, 8, 2, 128, seed=5)
    qp, kl = torch.tensor([999], dtype=torch.int32), torch.tensor([1000], dtype=torch.int32)
    kw = dict(scale=1.0 / np.sqrt(128))
    plan = TFA.decode_split_plan(1, 1, 8, 2, 1024, 128, 128, sms=2)
    assert plan["splits"] == 1 and TFA.decode_key_ranges(plan, 0, 1000) == [(0, 1000)]
    one = split_model(q, k, v, qp, kl, sms=2, **kw)
    ref = TFA.attention_ref(q, k, v, qp, kl, **kw).float()
    assert float((one - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


# ------------------------------------------------------- on the card --
# b, t, s, h, hkv, d, q_pos0, kv_len, extra: the split boundaries at T 1
# (round 256) and T 8 (round 128), head dims 64, 128 and 256 (4 warps a
# block), the 16/16 layout of Qwen1.5-MoE-A2.7B, a long cache, a batch
# whose rows take different paths (one range and split), every mask
CARD = {
    "kv256_whole": (1, 1, 4096, 32, 8, 128, [255], [256], {}),
    "kv257_split": (1, 1, 4096, 32, 8, 128, [256], [257], {}),
    "kv513": (1, 1, 1024, 32, 8, 128, [512], [513], {}),
    "kv4000": (1, 1, 4096, 32, 8, 128, [3999], [4000], {}),
    "t8_kv128_whole": (1, 8, 4096, 32, 8, 128, [120], [128], {}),
    "t8_kv129_split": (1, 8, 4096, 32, 8, 128, [121], [129], {}),
    "t8_kv4000": (1, 8, 4096, 32, 8, 128, [3992], [4000], {}),
    "t16_kv2000": (1, 16, 4096, 32, 8, 128, [1984], [2000], {}),
    "d64_kv1500": (1, 1, 2048, 32, 8, 64, [1499], [1500], {}),
    "d256_kv1500": (1, 2, 2048, 8, 2, 256, [1498], [1500], {}),
    "d256_kv129": (1, 1, 2048, 8, 2, 256, [128], [129], {}),
    "h16x16_kv513": (1, 1, 1024, 16, 16, 128, [512], [513], {}),
    "h16x16_kv3000": (1, 1, 4096, 16, 16, 128, [2999], [3000], {}),
    "b2_mixed": (2, 1, 1024, 32, 8, 128, [200, 999], [201, 1000], {}),
    "b4_t4": (4, 4, 2048, 32, 4, 128, [10, 500, 1020, 2000], [14, 504, 1024, 2004], {}),
    "swa": (1, 1, 4096, 32, 8, 128, [3999], [4000], {"swa_window": 1000}),
    "chunk": (1, 4, 4096, 32, 8, 128, [3000], [3004], {"attn_chunk": 2048}),
    "softcap_sinks": (1, 1, 4096, 32, 8, 128, [2500], [2501], {"softcap": 30.0, "sinks": True}),
}


def _card_case(b, t, s, h, hkv, d, qpos, kvlen, seed, extra):
    q, k, v = make(b, t, s, h, hkv, d, seed)
    qp = torch.tensor(qpos, dtype=torch.int32).cuda()
    kl = torch.tensor(kvlen, dtype=torch.int32).cuda()
    kw = _kw(extra, h, seed, d)
    if "sinks" in kw:
        kw["sinks"] = kw["sinks"].cuda()
    return (q.cuda(), k.cuda(), v.cuda(), qp, kl), kw


@needs_cuda
@pytest.mark.parametrize("case", list(CARD))
def test_decode_kernel_split_matches_plain(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra = CARD[case]
    args, kw = _card_case(b, t, s, h, hkv, d, qpos, kvlen, len(case), extra)
    got = TFA.flash_attention_decode(*args, **kw)
    ref = TFA.attention_ref(*args, **kw).float()
    assert got.shape == ref.shape and bool(torch.isfinite(got.float()).all())
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * max(float(ref.abs().max()),
                                                                     2.0 ** -20)
    for _ in range(3):
        assert torch.equal(TFA.flash_attention_decode(*args, **kw), got)


@needs_cuda
def test_decode_kernel_on_a_slab_of_a_stacked_cache():
    """The model passes kv.k[i], a strided view of (L, B, S, Hkv, D), and
    the split path reads it in place."""
    rng = np.random.default_rng(4)
    shape = (3, 2, 2048, 8, 128)
    kc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).cuda()
    vc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).cuda()
    q = torch.from_numpy(rng.standard_normal((2, 1, 32, 128)).astype(np.float32))
    q = q.to(torch.bfloat16).cuda()
    qp = torch.tensor([1499, 700], dtype=torch.int32).cuda()
    kl = torch.tensor([1500, 701], dtype=torch.int32).cuda()
    kw = dict(scale=1.0 / np.sqrt(128))
    got = TFA.flash_attention_decode(q, kc[1], vc[1], qp, kl, **kw)
    ref = TFA.attention_ref(q, kc[1], vc[1], qp, kl, **kw).float()
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    assert torch.equal(TFA.flash_attention_decode(q, kc[1], vc[1], qp, kl, **kw), got)
