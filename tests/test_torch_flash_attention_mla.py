"""The MLA form of the prefill attention kernel (``csrc/flash_attention_mla.cu``):
one kv head of head dims up to 576 / 512, the DeepSeek-2 family's latent
cache, at any T, by two kernels that ``mla_plan`` chooses between.

On the CPU: the dispatch rule, the launch plan (a pure function of the
shapes), the key ranges of the split blocks, a model of the kernels'
split and merge (each split's max, sum and unnormalised output over its
key tiles, merged with the factors exp(m_j - max)) against the plain
version, and the plain version at the real head dims against the JAX
package's Pallas kernel in interpret mode. On the card (skipped without
one): both kernels against the plain version at the main path's shapes
(DeepSeek-V2-Lite's 16 heads and DeepSeek-V3's 128) and at the edges of
their row tiles and key splits, v a view of k and v a tensor of its own,
cache rows past the fill that are not finite, their bits repeated, and
their refusals."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


def test_dispatch_rule():
    """One kv head above head dim 256 takes the MLA form; kernel B keeps
    every other shape (the mla=False path's 16 kv heads of 192 / 128)."""
    def t(*s):
        return torch.empty(s)
    assert TFA.mla_form(t(1, 4, 16, 576), t(1, 8, 1, 576), t(1, 8, 1, 512))
    assert TFA.mla_form(t(1, 4, 16, 192), t(1, 8, 1, 192), t(1, 8, 1, 320))
    assert not TFA.mla_form(t(1, 4, 16, 192), t(1, 8, 16, 192), t(1, 8, 16, 128))
    assert not TFA.mla_form(t(1, 4, 4, 80), t(1, 8, 1, 80), t(1, 8, 1, 64))
    assert not TFA.mla_form(t(1, 4, 16, 576), t(1, 8, 2, 576), t(1, 8, 2, 512))


@pytest.mark.parametrize("b,t,h,s,want", [
    # form, tiles, groups, splits
    (1, 512, 16, 4096, ("wgmma", 128, 128, 1)),   # a prefill chunk: 128 row tiles fill the card
    (1, 1, 16, 4096, ("decode", 1, 1, 64)),       # V2-Lite decode: one 16-row tile, keys over 64 blocks
    (2, 1, 16, 1024, ("decode", 1, 2, 16)),       # two slots: 1,024 keys, two chunks a block
    (1, 1, 16, 256, ("decode", 1, 1, 4)),         # a short cache
    (1, 16, 16, 4096, ("wgmma", 4, 4, 33)),       # 256 rows: four 64-row tiles, split keys
    (3, 100, 16, 4096, ("wgmma", 25, 75, 1)),
    (1, 1, 128, 4096, ("decode", 8, 8, 16)),      # DeepSeek-V3 decode: eight 16-row tiles
    (1, 512, 128, 4096, ("wgmma", 1024, 1024, 1)),
])
def test_split_plan(b, t, h, s, want):
    """``mla_plan``: the form, row tiles, groups and splits; its blocks fill
    the card without passing it where keys are split (a cooperative launch),
    and no split holds less than one key tile."""
    p = TFA.mla_plan(b, t, h, s, 132)
    assert (p["form"], p["tiles"], p["groups"], p["splits"]) == want
    assert p["rows"] == (16 if p["form"] == "decode" else 64) and p["cluster"] == 1
    assert p["splits"] == 1 or p["groups"] * p["splits"] <= 132
    assert p["splits"] <= max(1, -(-s // p["kt"])) and p["splits"] <= TFA.MLA_MAX_SPLITS
    assert p == TFA.mla_plan(b, t, h, s, 132)          # a pure function of its arguments


def test_mla_plan_forms_and_refusals():
    """The decode form for up to 128 rows a batch row (16 and 128 heads at
    T = 1), the wgmma form above; 32-key wgmma tiles where v is its own
    tensor; the plan follows the SM count and refuses empty or oversized
    shapes."""
    assert TFA.mla_plan(1, 1, 16, 4096)["form"] == "decode"
    assert TFA.mla_plan(1, 1, 128, 4096)["form"] == "decode"
    assert TFA.mla_plan(1, 8, 16, 4096)["form"] == "decode"
    assert TFA.mla_plan(1, 9, 16, 4096)["form"] == "wgmma"
    assert TFA.mla_plan(1, 512, 16, 4096)["form"] == "wgmma"
    assert TFA.mla_plan(1, 512, 16, 4096, alias=False)["kt"] == 32
    assert TFA.mla_plan(1, 1, 16, 4096, 40)["splits"] == 40
    assert TFA.mla_plan(200, 1, 16, 4096)["splits"] == 1
    for bad in ((0, 1, 16, 64), (1, 0, 16, 64), (1, 1, 0, 64), (1, 1, 16, 0), (70000, 1, 16, 64)):
        with pytest.raises(ValueError):
            TFA.mla_plan(*bad)


@pytest.mark.parametrize("splits", [1, 2, 5, 32])
@pytest.mark.parametrize("end", [1, 31, 32, 33, 500, 4000])
def test_key_ranges_cover_the_live_keys(splits, end):
    """The ranges tile [0, end) in order, each a whole number of the plan's
    key tiles but the last, at most ``splits`` of them, for both forms'
    tiles."""
    for kt in (TFA.MLA_DECODE_KT, TFA.MLA_WGMMA_KT):
        rs = TFA.mla_key_ranges({"splits": splits, "kt": kt}, end)
        assert rs[0][0] == 0 and rs[-1][1] == end and len(rs) <= splits
        for (lo, hi), (lo2, _) in zip(rs, rs[1:]):
            assert hi == lo2 and (hi - lo) % kt == 0


def _mla_inputs(b, t, s, h, dk, dv, seed, alias=True, device="cpu"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, t, h, dk), generator=g).to(torch.bfloat16).to(device)
    k = torch.randn((b, s, 1, dk), generator=g).to(torch.bfloat16).to(device)
    v = (k[..., :dv] if alias else
         torch.randn((b, s, 1, dv), generator=g).to(torch.bfloat16).to(device))
    return q, k, v


def _merged(q, k, v, qpos, kvlen, scale, plan):
    """A model of the kernels' split path in float64: each split walks its
    key range in the plan's ``kt``-key tiles with the online softmax
    (running max m, sum l, unnormalised output o, rescaled by exp(m_old -
    m_new) a tile); the merge folds the splits' states in split order into
    a running (max, sum, output) the same way, out = o / l."""
    b, t, h, _ = q.shape
    kt = plan["kt"]
    out = torch.zeros((b, t, h, v.shape[-1]), dtype=torch.float64)
    neg = torch.tensor(-1e30, dtype=torch.float64)

    def fold(state, m2, l2, o2):
        m, l, o = state
        mn = torch.maximum(m, m2)
        fa, fb = torch.exp(m - mn), torch.exp(m2 - mn)
        return mn, l * fa + l2 * fb, o * fa + o2 * fb

    for bb in range(b):
        pos = qpos[bb] + torch.arange(t)
        end = min(kvlen[bb], qpos[bb] + t)
        sc = torch.einsum("thd,sd->ths", q[bb].double(), k[bb, :, 0].double()) * scale
        keys = torch.arange(k.shape[1])
        allowed = (keys[None, :] <= pos[:, None]) & (keys[None, :] < kvlen[bb])
        empty = (torch.full((t, h, 1), -1e30, dtype=torch.float64),
                 torch.zeros((t, h, 1), dtype=torch.float64),
                 torch.zeros((t, h, v.shape[-1]), dtype=torch.float64))
        merged = empty
        for lo, hi in TFA.mla_key_ranges(plan, end):
            m, l, o = empty
            for k0 in range(lo, hi, kt):
                k1 = min(k0 + kt, hi)
                x = torch.where(allowed[:, None, k0:k1], sc[..., k0:k1], neg)
                mx = torch.maximum(m, x.amax(-1, keepdim=True))
                p = torch.where(allowed[:, None, k0:k1], torch.exp(x - mx), 0.0)
                alpha = torch.exp(m - mx)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + p @ v[bb, k0:k1, 0].double()
                m = mx
            merged = fold(merged, m, l, o)
        out[bb] = merged[2] / merged[1]
    return out


@pytest.mark.parametrize("splits", [1, 3, 32])
@pytest.mark.parametrize("kt", [TFA.MLA_DECODE_KT, TFA.MLA_WGMMA_KT])
def test_split_merge_model_matches_plain(splits, kt):
    """Merging the splits' partial states gives the plain softmax, up to
    float32 rounding of the plain version."""
    q, k, v = _mla_inputs(2, 3, 300, 4, 40, 32, 0)
    qpos, kvlen = [250, 120], [253, 123]
    got = _merged(q, k, v, qpos, kvlen, 0.1, {"splits": splits, "kt": kt})
    ref = TFA.attention_ref(q, k, v, torch.tensor(qpos), torch.tensor(kvlen), scale=0.1)
    # the plain version rounds its output to bf16 (q's dtype)
    assert float((got - ref.double()).abs().max()) <= 2.0 ** -8 * float(ref.abs().max())


def test_attention_ref_at_mla_dims_matches_pallas():
    """The plain version at the latent cache's head dims 576 / 512 (v a
    view of k's first 512 columns) against the JAX package's Pallas
    flash_attention in interpret mode, at one bf16 ulp."""
    import jax.numpy as jnp
    from ik_llama_cpp_tpu.ops.flash_attention import flash_attention as j_fa
    from test_torch_flash_attention import assert_within_ulp

    rng = np.random.default_rng(19)
    q = rng.standard_normal((2, 4, 3, 576)).astype(np.float32)
    k = rng.standard_normal((2, 64, 1, 576)).astype(np.float32)
    qpos, kvlen = [30, 56], [34, 60]
    tq, tk = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k))
    got = TFA.attention_ref(tq, tk, tk[..., :512], torch.tensor(qpos, dtype=torch.int32),
                            torch.tensor(kvlen, dtype=torch.int32), scale=0.05)
    jk = jnp.asarray(k, jnp.bfloat16)
    ref = j_fa(jnp.asarray(q, jnp.bfloat16), jk, jk[..., :512], jnp.asarray(qpos, jnp.int32),
               jnp.asarray(kvlen, jnp.int32), scale=0.05, block_q=8, block_kv=64,
               interpret=True)
    assert got.shape == (2, 4, 3, 512)
    assert_within_ulp(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_cpu_takes_the_plain_version_at_mla_shapes():
    q, k, v = _mla_inputs(1, 5, 64, 16, 576, 512, 1)
    args = (q, k, v, torch.tensor([40]), torch.tensor([45]))
    assert torch.equal(TFA.flash_attention(*args, scale=0.07),
                       TFA.attention_ref(*args, scale=0.07))


# b, t, s, h, dk, dv, q_pos0, kv_len, alias: the absorb path's shapes (the
# last chunk of a 3,999-token fill, the decode step after it, two slots) on
# both kernels, row counts that are not whole row tiles, T = 16 with split
# keys, kv_len inside a key tile and below a row's position, head dims below
# the maximum, v a tensor of its own, and DeepSeek-V3's 128 heads
CARD = {
    "fill_last_chunk": (1, 512, 4096, 16, 576, 512, [3488], [4000], True),
    "decode_4000": (1, 1, 4096, 16, 576, 512, [3999], [4000], True),
    "decode_two_slots": (2, 1, 1024, 16, 576, 512, [512, 900], [513, 901], True),
    "first_chunk": (1, 512, 1024, 16, 576, 512, [0], [512], True),
    "t17_partial_tile": (1, 17, 256, 16, 576, 512, [30], [47], True),
    "t16_split": (1, 16, 4096, 16, 576, 512, [2000], [2016], True),
    "kv_shorter_than_pos": (1, 64, 512, 16, 576, 512, [300], [280], True),
    "h4_short_cache": (2, 7, 128, 4, 576, 512, [0, 60], [7, 67], True),
    "dims_320_288": (1, 33, 256, 16, 320, 288, [100], [133], True),
    "separate_v": (1, 100, 512, 16, 576, 512, [200], [300], False),
    "separate_v_decode": (1, 1, 2048, 16, 576, 512, [1500], [1501], False),
    "separate_v_dims": (2, 9, 256, 8, 264, 136, [10, 100], [19, 109], False),
    "h128_decode": (1, 1, 4096, 128, 576, 512, [3999], [4000], True),
    "h128_prefill": (1, 512, 1024, 128, 576, 512, [500], [1012], True),
}


def _card_case(case, nan_past_fill=False):
    b, t, s, h, dk, dv, qpos, kvlen, alias = CARD[case]
    q, k, v = _mla_inputs(b, t, s, h, dk, dv, 7, alias, "cuda")
    args = (q, k, v, torch.tensor(qpos, device="cuda", dtype=torch.int32),
            torch.tensor(kvlen, device="cuda", dtype=torch.int32))
    ref = TFA.attention_ref(*args, scale=0.05)
    if nan_past_fill:            # stale cache rows past the fill that are not finite
        for bb, n in enumerate(kvlen):
            k[bb, n:] = float("nan")
            if not alias:
                v[bb, n:] = float("nan")
    before = (TFA.flash_attention.launches, TFA.flash_attention.mla_launches)
    got = TFA.flash_attention(*args, scale=0.05)
    assert (TFA.flash_attention.launches, TFA.flash_attention.mla_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, t, h, dv)
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2.0 ** -7 * float(ref.float().abs().max()), err
    assert torch.equal(got, TFA.flash_attention(*args, scale=0.05))    # bit repeat


@needs_cuda
@pytest.mark.parametrize("case", list(CARD))
def test_mla_kernel_matches_plain(case):
    _card_case(case)


@needs_cuda
@pytest.mark.parametrize("case", ["decode_4000", "decode_two_slots", "fill_last_chunk",
                                  "t17_partial_tile", "separate_v", "separate_v_decode"])
def test_mla_kernel_nan_past_the_fill(case):
    """NaN in every cache row at and past kv_len: the kernels never let a
    row past the fill reach the output (p = 0 there, and no 0 x NaN)."""
    _card_case(case, nan_past_fill=True)


@needs_cuda
def test_mla_kernel_takes_positions_from_the_host():
    """q_pos0 / kv_len as Python ints, as int64 tensors and as int32 device
    tensors give the same bits (the wrapper holds the int32 copies it makes
    until the launch)."""
    q, k, v = _mla_inputs(2, 3, 512, 16, 576, 512, 5, True, "cuda")
    want = TFA.flash_attention(q, k, v, torch.tensor([300, 300], device="cuda",
                                                     dtype=torch.int32),
                               torch.tensor([303, 303], device="cuda", dtype=torch.int32),
                               scale=0.05)
    for qp, kl in ((300, 303), (torch.tensor([300, 300]), torch.tensor([303, 303])),
                   (torch.tensor([300, 300], device="cuda"),
                    torch.tensor([303, 303], device="cuda"))):
        assert torch.equal(TFA.flash_attention(q, k, v, qp, kl, scale=0.05), want)


@needs_cuda
def test_mla_kernel_refusals():
    q, k, v = _mla_inputs(1, 4, 64, 16, 576, 512, 3, True, "cuda")
    qp = torch.tensor([10], device="cuda", dtype=torch.int32)
    kl = torch.tensor([14], device="cuda", dtype=torch.int32)
    for kw in ({"softcap": 30.0}, {"swa_window": 8}, {"attn_chunk": 8},
               {"sinks": torch.zeros(16, device="cuda")}):
        with pytest.raises(ValueError):
            TFA.flash_attention(q, k, v, qp, kl, scale=0.05, **kw)
    big = torch.zeros((1, 4, 16, 584), dtype=torch.bfloat16, device="cuda")
    kb = torch.zeros((1, 64, 1, 584), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        TFA.flash_attention(big, kb, kb[..., :512], qp, kl, scale=0.05)
    with pytest.raises(ValueError):
        TFA.flash_attention(q.float(), k, v, qp, kl, scale=0.05)
    # the wgmma form (64 rows and up) reads q as contiguous rows
    qt = torch.zeros((1, 16, 16, 576), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        TFA.flash_attention(qt, kb[..., :576], kb[..., :512], qp, kl, scale=0.05)
