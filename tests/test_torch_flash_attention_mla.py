"""The MLA form of the prefill attention kernel (``csrc/flash_attention_mla.cu``):
one kv head of head dims up to 576 / 512, the DeepSeek-2 family's latent
cache, at any T.

On the CPU: the dispatch rule, the launch plan (a pure function of the
shapes), the key ranges of the split blocks, and a model of the kernel's
split and merge (each split's max, sum and unnormalised output, merged in
split order) against the plain version. On the card (skipped without one):
the kernel against the plain version at the main path's shapes and at the
edges of its row tiles and key splits, v a view of k and v a tensor of its
own, its bits repeated, and its refusals."""
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
    (1, 512, 16, 4096, (128, 128, 1)),      # a prefill chunk: 128 row tiles fill the card
    (1, 1, 16, 4096, (1, 1, 32)),           # decode: one row tile, its keys over 32 blocks
    (2, 1, 16, 1024, (1, 2, 8)),            # two slots: 8 blocks each, 1,024 keys
    (1, 1, 16, 256, (1, 1, 2)),             # a short cache: at least four tiles a block
    (1, 16, 16, 4096, (4, 4, 32)),
    (3, 100, 16, 4096, (25, 75, 1)),
])
def test_split_plan(b, t, h, s, want):
    p = TFA.mla_split_plan(b, t, h, s, 132)
    assert (p["tiles"], p["groups"], p["splits"]) == want
    assert p["groups"] * p["splits"] <= max(132, p["groups"])


@pytest.mark.parametrize("splits", [1, 2, 5, 32])
@pytest.mark.parametrize("end", [1, 31, 32, 33, 500, 4000])
def test_key_ranges_cover_the_live_keys(splits, end):
    """The ranges tile [0, end) in order, each a whole number of 32-key
    tiles but the last, at most ``splits`` of them."""
    rs = TFA.mla_key_ranges(splits, end)
    assert rs[0][0] == 0 and rs[-1][1] == end and len(rs) <= splits
    for (lo, hi), (lo2, _) in zip(rs, rs[1:]):
        assert hi == lo2 and (hi - lo) % TFA.MLA_KT == 0


def _mla_inputs(b, t, s, h, dk, dv, seed, alias=True, device="cpu"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, t, h, dk), generator=g).to(torch.bfloat16).to(device)
    k = torch.randn((b, s, 1, dk), generator=g).to(torch.bfloat16).to(device)
    v = (k[..., :dv] if alias else
         torch.randn((b, s, 1, dv), generator=g).to(torch.bfloat16).to(device))
    return q, k, v


def _merged(q, k, v, qpos, kvlen, scale, splits):
    """A model of the kernel's split path in float64: each split's
    (max, sum, unnormalised output) over its key range, merged in split
    order with the factors exp(m_j - max)."""
    b, t, h, _ = q.shape
    out = torch.zeros((b, t, h, v.shape[-1]), dtype=torch.float64)
    for bb in range(b):
        pos = qpos[bb] + torch.arange(t)
        end = min(kvlen[bb], qpos[bb] + t)
        sc = torch.einsum("thd,sd->ths", q[bb].double(), k[bb, :, 0].double()) * scale
        keys = torch.arange(k.shape[1])
        allowed = (keys[None, :] <= pos[:, None]) & (keys[None, :] < kvlen[bb])
        parts = []
        for lo, hi in TFA.mla_key_ranges(splits, end):
            m = torch.where(allowed[:, None, lo:hi], sc[..., lo:hi],
                            torch.tensor(-1e30, dtype=torch.float64))
            mx = m.amax(-1, keepdim=True)
            p = torch.where(allowed[:, None, lo:hi], torch.exp(m - mx), 0.0)
            parts.append((mx, p.sum(-1, keepdim=True), p @ v[bb, lo:hi, 0].double()))
        mm = torch.stack([p[0] for p in parts]).amax(0)
        ls = sum(p[1] * torch.exp(p[0] - mm) for p in parts)
        out[bb] = sum(p[2] * torch.exp(p[0] - mm) for p in parts) / ls
    return out


@pytest.mark.parametrize("splits", [1, 3, 32])
def test_split_merge_model_matches_plain(splits):
    """Merging the splits' partial states gives the plain softmax, up to
    float32 rounding of the plain version."""
    q, k, v = _mla_inputs(2, 3, 300, 4, 40, 32, 0)
    qpos, kvlen = [250, 120], [253, 123]
    got = _merged(q, k, v, qpos, kvlen, 0.1, splits)
    ref = TFA.attention_ref(q, k, v, torch.tensor(qpos), torch.tensor(kvlen), scale=0.1)
    # the plain version rounds its output to bf16 (q's dtype)
    assert float((got - ref.double()).abs().max()) <= 2.0 ** -8 * float(ref.abs().max())


def test_cpu_takes_the_plain_version_at_mla_shapes():
    q, k, v = _mla_inputs(1, 5, 64, 16, 576, 512, 1)
    args = (q, k, v, torch.tensor([40]), torch.tensor([45]))
    assert torch.equal(TFA.flash_attention(*args, scale=0.07),
                       TFA.attention_ref(*args, scale=0.07))


# b, t, s, h, dk, dv, q_pos0, kv_len, alias: the absorb path's shapes (the
# last chunk of a 3,999-token fill, the decode step after it, two slots),
# row counts that are not whole 64-row tiles, T = 16 with split keys,
# kv_len inside a key tile and below a row's position, head dims below the
# maximum, and v a tensor of its own (16-key tiles)
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
}


@needs_cuda
@pytest.mark.parametrize("case", list(CARD))
def test_mla_kernel_matches_plain(case):
    b, t, s, h, dk, dv, qpos, kvlen, alias = CARD[case]
    q, k, v = _mla_inputs(b, t, s, h, dk, dv, 7, alias, "cuda")
    args = (q, k, v, torch.tensor(qpos, device="cuda", dtype=torch.int32),
            torch.tensor(kvlen, device="cuda", dtype=torch.int32))
    before = (TFA.flash_attention.launches, TFA.flash_attention.mla_launches)
    got = TFA.flash_attention(*args, scale=0.05)
    assert (TFA.flash_attention.launches, TFA.flash_attention.mla_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = TFA.attention_ref(*args, scale=0.05)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, t, h, dv)
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2.0 ** -7 * float(ref.float().abs().max()), err
    assert torch.equal(got, TFA.flash_attention(*args, scale=0.05))    # bit repeat


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
