"""Flash attention over a fixed-capacity KV cache: prefill and decode.

Two wrappers with one contract (the JAX package's ``flash_attention`` and
``flash_attention_decode``): q (B, T, H, Dk) attends causally from absolute
positions q_pos0 .. q_pos0 + T - 1 to the cache rows < kv_len of k/v
(B, S, Hkv, D*), with GQA, logit softcap, sliding window, llama4 attention
chunks and per-head sinks; the result is (B, T, H, Dv) in q's dtype.

A CPU tensor takes the plain version (``ops/attention.attend``); a CUDA
tensor launches the kernel (``csrc/flash_attention.cu`` for prefill,
``csrc/flash_attention_decode.cu`` for T <= 16) or raises. The prefill
wrapper has a second form for one kv head of head dims above 256, the MLA
latent cache of the DeepSeek-2 family (``csrc/flash_attention_mla.cu``,
any T).

Two more wrappers take a quantized cache (``ops/kv_quant.py``): codes
k_q/v_q (B, S, Hkv, W) with float32 row scales k_s/v_s (B, S, Hkv).
``flash_attention_decode_q8`` (T <= 16, all four codecs,
``csrc/flash_attention_decode_q.cu``) and ``flash_attention_q8`` (any T,
int8 codes, ``csrc/flash_attention_q8.cu``); their plain version is
``attention_quant_ref``.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import attend
from .kv_quant import KV_DECODERS, kv_codec_of

DECODE_MAX_T = 16
_CODEC_ID = {"q8": 0, "q4": 1, "q6": 2, "nl4": 3}      # csrc/fa_quant.cuh


def _vec(x, b: int, device) -> torch.Tensor:
    """Scalar or (B,) position/length -> int32 (B,) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def attention_ref(q, k, v, q_pos0, kv_len, *, scale: float,
                  softcap: float = 0.0, swa_window: int = 0,
                  attn_chunk: int = 0, sinks=None):
    """Plain version of both kernels: ``attend`` with q_pos from q_pos0."""
    b, t = q.shape[:2]
    npv = _vec(q_pos0, b, q.device)
    q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=q.device)[None, :]
    return attend(q, k, v, q_pos=q_pos, kv_len=_vec(kv_len, b, q.device),
                  scale=scale, softcap=softcap, swa_window=swa_window,
                  sinks=sinks, attn_chunk=attn_chunk)


def _split_args(split):
    """The ctypes arguments and their types of a decode kernel's split,
    (scratch, counters, splits) or None for a kernel that takes none."""
    if split is None:
        return (), []
    part, counters, splits = split
    return ((None if part is None else part.data_ptr(),
             None if counters is None else counters.data_ptr(), splits),
            [_cuda.P, _cuda.P, _cuda.I])


def _launch(symbol, lib, q, k, v, q_pos0, kv_len, scale, softcap, swa_window,
            attn_chunk, sinks, split=None):
    """Checks and launches one attention kernel; ``split`` = (scratch,
    counters, splits) for the decode kernel, which takes them after out."""
    b, t, h, dk = q.shape
    _, s, hkv, dk2 = k.shape
    dv = v.shape[3]
    _cuda.require(dk == dk2 and v.shape[:3] == k.shape[:3] and k.shape[0] == b,
                  f"{lib}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    _cuda.require(h % hkv == 0, f"{lib}: {h} heads over {hkv} kv heads")
    _cuda.require(dk % 8 == 0 and dv % 8 == 0 and max(dk, dv) <= 256,
                  f"{lib}: head dims ({dk}, {dv}) must be multiples of 8 up to 256")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _cuda.require(x.dtype == torch.bfloat16, f"{lib}: {name} must be bf16")
        _cuda.require(x.device == q.device, f"{lib}: {name} on another device")
        _cuda.require(x.stride(3) == 1 and all(st % 8 == 0 for st in x.stride()[:3])
                      and x.data_ptr() % 16 == 0,
                      f"{lib}: {name} needs a unit last stride and 16-byte aligned rows")
    qp = _vec(q_pos0, b, q.device)
    kl = _vec(kv_len, b, q.device)
    sk = None
    if sinks is not None:
        sk = sinks.to(device=q.device, dtype=torch.float32).reshape(h).contiguous()
    out = torch.empty((b, t, h, dv), dtype=torch.bfloat16, device=q.device)
    extra, extra_types = _split_args(split)
    fn = _cuda.function(lib, symbol, [_cuda.P] * 7 + extra_types + [_cuda.I] * 6
                        + [_cuda.L] * 9 + [_cuda.F] * 2 + [_cuda.I] * 2
                        + [_cuda.P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kl.data_ptr(), None if sk is None else sk.data_ptr(),
            out.data_ptr(), *extra, b, t, h, hkv, dk, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), float(softcap), int(swa_window), int(attn_chunk),
            _cuda.stream_ptr(q))
    return rc, out


# The MLA form of the prefill kernel (csrc/flash_attention_mla.cu): head
# dims up to 576 / 512 over one kv head, two kernels chosen by ``mla_plan``.
# The decode kernel takes 16-row tiles and 32-key chunks where a batch row
# has at most MLA_DECODE_MAX_ROWS query rows (T * H); the wgmma kernel takes
# 64-row tiles and 64-key tiles (32 where v is not a view of k). Either
# splits a row tile's live keys over blocks where the row tiles leave SMs
# idle, the blocks of a split group merging their partials together.
MLA_DK, MLA_DV = 576, 512
MLA_DECODE_ROWS, MLA_DECODE_KT, MLA_DECODE_MAX_ROWS = 16, 32, 128
MLA_WGMMA_ROWS, MLA_WGMMA_KT = 64, 64
MLA_MAX_SPLITS = 256


def mla_form(q, k, v) -> bool:
    """Whether ``flash_attention`` takes its MLA form: one kv head and a
    head dim above kernel B's 256."""
    return k.dim() == 4 and k.shape[2] == 1 and max(q.shape[3], v.shape[3]) > 256


def mla_plan(b: int, t: int, h: int, s: int, sms: int = _cuda.DEFAULT_SMS, *,
             alias: bool = True) -> dict:
    """The MLA form's launch, a pure function of the shapes and the SM
    count. ``form``: "decode" (``fa_mla_decode_kernel``) where a batch row's
    T x H query rows are at most MLA_DECODE_MAX_ROWS (16 at a V2-Lite decode
    step, 128 at DeepSeek-V3's), else "wgmma" (``fa_mla_wgmma_kernel``).
    ``rows`` a row tile, ``kt`` keys a tile (the wgmma form takes 32 where v
    is not a view of k: ``alias`` False), ``tiles`` row tiles a batch row,
    ``groups`` = B x tiles, ``splits`` blocks a group: as many as leave no
    SM idle, no more than give each block two key tiles of the S cache rows
    at the decode form (the split sweep of chip_smoke.py's phase 3: 64
    blocks of 2 chunks beat 128 of one at 4,000 keys) or one at the wgmma
    form (1 at T = 512, where the 128 row tiles fill the card). A split call
    is a cooperative launch, so its groups x splits blocks never pass the
    SM count (one block an SM). ``cluster``: blocks of a thread-block
    cluster, 1 (pairs of row tiles sharing each K tile by TMA multicast
    halved the tiles' reads from L2 but ran slower at rows 2m and 2m128:
    PERF.md)."""
    if not (b > 0 and t > 0 and h > 0 and s > 0 and sms > 0) or b > 65535:
        raise ValueError(f"flash_attention (MLA form): B={b} T={t} H={h} S={s}")
    decode = t * h <= MLA_DECODE_MAX_ROWS
    rows = MLA_DECODE_ROWS if decode else MLA_WGMMA_ROWS
    kt = MLA_DECODE_KT if decode else (MLA_WGMMA_KT if alias else MLA_WGMMA_KT // 2)
    tiles = -(-t * h // rows)
    groups = b * tiles
    per_split = 2 * kt if decode else kt
    splits = max(1, min(sms // groups, -(-s // per_split), MLA_MAX_SPLITS))
    return {"form": "decode" if decode else "wgmma", "rows": rows, "kt": kt, "tiles": tiles,
            "groups": groups, "splits": splits, "cluster": 1}


def mla_key_ranges(plan: dict, key_end: int) -> list:
    """The blocks' key ranges [lo, hi) of one row tile whose live keys are
    [0, key_end), in split order, as the kernels derive them from kv_len and
    q_pos0: chunks of ``per`` keys, a whole number of the plan's ``kt``-key
    tiles (the last may be shorter); one range where that leaves one chunk;
    blocks past the last chunk do nothing."""
    splits, kt = plan["splits"], plan["kt"]
    per = max(-(-(-(-key_end // splits)) // kt) * kt, kt)
    if -(-key_end // per) <= 1:
        return [(0, key_end)]
    return [(lo, min(lo + per, key_end)) for lo in range(0, key_end, per)]


def _flash_attention_mla(q, k, v, q_pos0, kv_len, scale: float):
    """Checks and launches the MLA form's kernel; returns (rc, out)."""
    lib = "flash_attention_mla"
    b, t, h, dk = q.shape
    _, s, hkv, dk2 = k.shape
    dv = v.shape[3]
    _cuda.require(dk == dk2 and hkv == 1 and v.shape[:3] == k.shape[:3] and k.shape[0] == b,
                  f"{lib}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    _cuda.require(dk % 8 == 0 and dv % 8 == 0 and dk <= MLA_DK and dv <= MLA_DV,
                  f"{lib}: head dims ({dk}, {dv}) must be multiples of 8 up to "
                  f"({MLA_DK}, {MLA_DV})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _cuda.require(x.dtype == torch.bfloat16, f"{lib}: {name} must be bf16")
        _cuda.require(x.device == q.device, f"{lib}: {name} on another device")
        _cuda.require(x.stride(3) == 1 and all(st % 8 == 0 for st in x.stride()[:3])
                      and x.data_ptr() % 16 == 0,
                      f"{lib}: {name} needs a unit last stride and 16-byte aligned rows")
    # v a view of k's first dv columns: the kernels read each key row once
    alias = v.data_ptr() == k.data_ptr() and v.stride() == k.stride() and dv <= dk
    plan = mla_plan(b, t, h, s, _cuda.sm_count(q), alias=alias)
    qst = q.stride()[:3]
    if plan["form"] == "wgmma":
        # TMA reads q as the (B * T * H, Dk) rows of one matrix
        _cuda.require(q.is_contiguous(), f"{lib}: the wgmma form needs a contiguous q")
        qst = (t * h * dk, h * dk, dk)
    splits = plan["splits"]
    part = counters = None
    if splits > 1:
        part = torch.empty(plan["groups"] * splits * plan["rows"] * (dv + 2),
                           dtype=torch.float32, device=q.device)
        counters = _cuda.zeroed_counters(q.device, "mla merge", 2 * plan["groups"])
    # every buffer the kernel reads is held by a name until the launch
    qp = _vec(q_pos0, b, q.device)
    kl = _vec(kv_len, b, q.device)
    out = torch.empty((b, t, h, dv), dtype=torch.bfloat16, device=q.device)
    fn = _cuda.function(lib, "ik_flash_attention_mla",
                        [_cuda.P] * 8 + [_cuda.I] * 9 + [_cuda.L] * 7 + [_cuda.F, _cuda.P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kl.data_ptr(),
            out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            0 if plan["form"] == "decode" else 1, splits, int(alias), b, t, h, s, dk, dv,
            *qst, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), _cuda.stream_ptr(q))
    return rc, out


def flash_attention(q, k, v, q_pos0, kv_len, *, scale: float,
                    softcap: float = 0.0, swa_window: int = 0,
                    attn_chunk: int = 0, sinks=None):
    """Prefill attention (any T). CUDA kernel ``csrc/flash_attention.cu``,
    which replaces the Pallas kernel flash_attention.py:flash_attention of
    the JAX package. It is bound by bf16 tensor-core work on the live part
    of the causal score matrix and, at T = 512, by the serial walk of the
    last query tile over its key tiles; each block loops only over its live
    key range, which is what the TPU kernel's tile clamp achieved by
    skipping DMAs, with the next key tile in flight (cp.async) while the
    current one is multiplied, K and V row-major read by ldmatrix, Q held
    in registers at head dims up to 128, and the longest query tiles
    launched first.

    One kv head at head dims above 256 (``mla_form``: the DeepSeek-2
    family's latent cache, q (B, T, H, 576) over k (B, S, 1, 576) and v its
    first 512 columns) takes the MLA form, ``csrc/flash_attention_mla.cu``,
    at any T: the heads of a few positions packed into a block's rows so
    that the latent head is read once for all of them. ``mla_plan`` picks
    one of its two kernels: at prefill warpgroup MMAs over TMA tiles (64
    rows, two consumer warpgroups of 256 output columns), at decode 16-row
    tiles whose keys are split over every SM and merged by the group's
    blocks together. It takes the causal mask alone and raises on a
    softcap, window, chunk or sinks. ``flash_attention.mla_launches``
    counts its part of ``launches``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos0, kv_len, scale=scale,
                             softcap=softcap, swa_window=swa_window,
                             attn_chunk=attn_chunk, sinks=sinks)
    if mla_form(q, k, v):
        _cuda.require(softcap == 0.0 and swa_window == 0 and attn_chunk == 0 and sinks is None,
                      "flash_attention (MLA form): the causal mask only (no softcap, "
                      "window, chunk or sinks)")
        rc, out = _flash_attention_mla(q, k, v, q_pos0, kv_len, scale)
        flash_attention.launches += 1
        flash_attention.mla_launches += 1
        _cuda.check(rc, "flash_attention (MLA form)")
        return out
    rc, out = _launch("ik_flash_attention", "flash_attention", q, k, v,
                      q_pos0, kv_len, scale, softcap, swa_window, attn_chunk,
                      sinks)
    flash_attention.launches += 1
    _cuda.check(rc, "flash_attention")
    return out


flash_attention.launches = 0      # kernel launches, counted where they happen
flash_attention.mla_launches = 0  # ... of them the MLA form's


# The decode kernel (csrc/flash_attention_decode.cu): 32-key tiles, 8 warps
# a block (4 at head dims above 128), each (batch, kv head, row tile)
# group's live keys split over up to DECODE_MAX_SPLITS blocks.
DECODE_KT = 32
DECODE_MAX_SPLITS = 32


def decode_split_plan(b: int, t: int, h: int, hkv: int, s: int, dk: int, dv: int,
                      sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of the decode kernel, a pure function of the shapes and
    the SM count (never of kv_len, which stays on the device). The q rows
    of a kv head (GQA group x T) are cut into row tiles of ``rows``; a
    block runs ``warps`` warps, ``ksplit`` of them over the keys of each 16
    rows, so one round of the block's warps covers ``round`` keys. There
    are ``groups`` (batch, kv head, row tile) groups and each gets
    ``splits`` blocks: enough for one block an SM, no more than a capacity
    of S keys can give whole rounds, at most DECODE_MAX_SPLITS."""
    if not (1 <= t <= DECODE_MAX_T and h % hkv == 0 and s > 0 and sms > 0):
        raise ValueError(f"flash_attention_decode: T={t} H={h} Hkv={hkv} S={s}")
    d = max(dk, dv)
    warps = 8 if d <= 128 else 4
    mt = -(-(h // hkv) * t // 16)
    mtb = 1
    while mtb < mt and mtb < warps:
        mtb *= 2
    ksplit = warps // mtb
    rnd = ksplit * DECODE_KT
    groups = b * hkv * -(-mt // mtb)
    splits = max(1, min(-(-s // rnd), -(-sms // groups), DECODE_MAX_SPLITS))
    return {"warps": warps, "rows": 16 * mtb, "row_groups": -(-mt // mtb), "ksplit": ksplit,
            "round": rnd, "groups": groups, "splits": splits}


def decode_key_ranges(plan: dict, key_start: int, key_end: int) -> list:
    """The blocks' key ranges [lo, hi) of one group whose live keys are
    [key_start, key_end), in split order (the kernel derives the same from
    kv_len and q_pos0). One range where the live keys fit one round of the
    block's warps or the plan has one split: block 0 then runs the
    partition of the kernel's first port. Otherwise chunks of a whole
    number of 32-key tiles, at least one round, so that every tile stays
    inside its block's range; blocks past the last chunk do nothing."""
    live = max(key_end - key_start, 0)
    if plan["splits"] == 1 or live <= plan["round"]:
        return [(key_start, key_end)]
    per = -(-live // plan["splits"])
    per = max(-(-per // DECODE_KT) * DECODE_KT, plan["round"])
    return [(lo, min(lo + per, key_end)) for lo in range(key_start, key_end, per)]


def _decode_split(q, hkv: int, s: int, dv: int):
    """(scratch, counters, splits) of a decode kernel's launch (C or 5) for
    q (B, T, H, Dk) over a slab of ``hkv`` kv heads and capacity ``s``: the
    float32 scratch of the splits' partial states (none for one split) and
    the zeroed counters, one a group. The two kernels share the counters:
    calls on one stream run in order, and each leaves them zero."""
    b, t, h, dk = q.shape
    plan = decode_split_plan(b, t, h, hkv, s, dk, dv, _cuda.sm_count(q))
    if plan["splits"] == 1:
        return None, None, 1
    part = torch.empty(plan["groups"] * plan["splits"] * plan["rows"] * (dv + 2),
                       dtype=torch.float32, device=q.device)
    counters = _cuda.zeroed_counters(q.device, "decode attention", plan["groups"])
    return part, counters, plan["splits"]


def flash_attention_decode(q, k, v, q_pos0, kv_len, *, scale: float,
                           softcap: float = 0.0, swa_window: int = 0,
                           attn_chunk: int = 0, sinks=None):
    """Decode / short-chunk attention (T <= 16) over a (B, S, Hkv, D) layer
    slab, which may be a view of the model's stacked cache. CUDA kernel
    ``csrc/flash_attention_decode.cu``, which replaces the Pallas kernel
    flash_attention.py:flash_attention_decode (quant none) of the JAX
    package. It is bound by the filled K/V bytes; the q rows of a GQA group
    share each K/V tile, so the cache is read once per kv head, and each
    group's live keys are split over the blocks of ``decode_split_plan``,
    whose partial softmax states the last block to finish merges in split
    order: one launch, no host sync. Unlike the TPU kernel it takes any S
    and any head dim up to 256 that is a multiple of 8, and raises on
    anything else instead of returning None."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos0, kv_len, scale=scale,
                             softcap=softcap, swa_window=swa_window,
                             attn_chunk=attn_chunk, sinks=sinks)
    b, t, h, _ = q.shape
    _cuda.require(t <= DECODE_MAX_T, f"flash_attention_decode: T={t} > {DECODE_MAX_T}")
    _cuda.require(k.dim() == 4 and h % k.shape[2] == 0,
                  f"flash_attention_decode: {h} heads over kv {tuple(k.shape)}")
    rc, out = _launch("ik_flash_attention_decode", "flash_attention_decode",
                      q, k, v, q_pos0, kv_len, scale, softcap, swa_window,
                      attn_chunk, sinks,
                      split=_decode_split(q, k.shape[2], k.shape[1], v.shape[3]))
    flash_attention_decode.launches += 1
    _cuda.check(rc, "flash_attention_decode")
    return out


flash_attention_decode.launches = 0


# --------------------------------------------------------------------------
# quantized KV cache
# --------------------------------------------------------------------------

def attention_quant_ref(q, k_q, k_s, v_q, v_s, q_pos0, kv_len, *, scale: float,
                        softcap: float = 0.0, swa_window: int = 0,
                        attn_chunk: int = 0, sinks=None):
    """Plain version of both quantized-cache kernels: decode the cache with
    its codec, then ``attend``. K stays float32 (code * k_scale, as the
    kernels' float32 scores); V is rounded to bf16 as the kernels round it
    before the PV product."""
    codec = kv_codec_of(k_q, q.shape[-1])
    k = KV_DECODERS[codec](k_q, k_s)
    v = KV_DECODERS[codec](v_q, v_s).to(torch.bfloat16)
    return attention_ref(q, k, v, q_pos0, kv_len, scale=scale, softcap=softcap,
                         swa_window=swa_window, attn_chunk=attn_chunk,
                         sinks=sinks)


def _launch_quant(symbol, lib, codec, q, k_q, k_s, v_q, v_s, q_pos0, kv_len,
                  scale, softcap, swa_window, attn_chunk, sinks, split: bool = False):
    """Checks and launches one quantized-cache kernel, which takes after
    out: the split scratch, counters and count (``split``: the decode
    kernel), or the query heads a block (the prefill kernel)."""
    b, t, h, dk = q.shape
    _, s, hkv, wk = k_q.shape
    wv = v_q.shape[3]
    _cuda.require(k_q.shape[0] == b and v_q.shape[:3] == k_q.shape[:3]
                  and k_s.shape == k_q.shape[:3] and v_s.shape == k_q.shape[:3],
                  f"{lib}: shapes q {tuple(q.shape)} k {tuple(k_q.shape)} "
                  f"v {tuple(v_q.shape)} scales {tuple(k_s.shape)} {tuple(v_s.shape)}")
    _cuda.require(h % hkv == 0, f"{lib}: {h} heads over {hkv} kv heads")
    _cuda.require(v_q.dtype == k_q.dtype,
                  f"{lib}: k and v must use the same codec")
    if codec == "q8":
        dv = wv
        _cuda.require(wk == dk and dk % 8 == 0 and dv % 8 == 0 and max(dk, dv) <= 256,
                      f"{lib}: head dims ({dk}, {dv}) must be multiples of 8 up to 256")
    else:
        # packed rows: 8-byte loads per bit plane need D % 32 == 0
        dv = {"q4": 2 * wv, "nl4": 2 * wv, "q6": 4 * wv // 3}[codec]
        _cuda.require(dk == dv and dk % 32 == 0 and dk <= 256,
                      f"{lib}: the {codec} codec needs equal k and v head dims that "
                      f"are multiples of 32 up to 256, got ({dk}, {dv})")
    _cuda.require(q.dtype == torch.bfloat16 and q.stride(3) == 1
                  and all(st % 8 == 0 for st in q.stride()[:3])
                  and q.data_ptr() % 16 == 0,
                  f"{lib}: q must be bf16 with a unit last stride and 16-byte aligned rows")
    for name, x in (("k", k_q), ("v", v_q)):
        _cuda.require(x.device == q.device, f"{lib}: {name} on another device")
        _cuda.require(x.stride(3) == 1 and all(st % 8 == 0 for st in x.stride()[:3])
                      and x.data_ptr() % 8 == 0,
                      f"{lib}: {name} codes need a unit last stride and 8-byte aligned rows")
    for name, x in (("k_s", k_s), ("v_s", v_s)):
        _cuda.require(x.dtype == torch.float32 and x.stride(2) == 1
                      and x.device == q.device,
                      f"{lib}: {name} must be float32 with a unit last stride")
    qp = _vec(q_pos0, b, q.device)
    kl = _vec(kv_len, b, q.device)
    sk = None
    if sinks is not None:
        sk = sinks.to(device=q.device, dtype=torch.float32).reshape(h).contiguous()
    out = torch.empty((b, t, h, dv), dtype=torch.bfloat16, device=q.device)
    if split:
        extra, extra_types = _split_args(_decode_split(q, hkv, s, dv))
    else:
        extra, extra_types = (prefill_q8_heads(h, hkv, max(dk, dv)),), [_cuda.I]
    fn = _cuda.function(lib, symbol, [_cuda.P] * 9 + extra_types + [_cuda.I] * 7
                        + [_cuda.L] * 13 + [_cuda.F] * 2 + [_cuda.I] * 2
                        + [_cuda.P])
    rc = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), qp.data_ptr(), kl.data_ptr(),
            None if sk is None else sk.data_ptr(), out.data_ptr(), *extra,
            _CODEC_ID[codec], b, t, h, hkv, dk, dv,
            *q.stride()[:3], *k_q.stride()[:3], *v_q.stride()[:3],
            *k_s.stride()[:2], *v_s.stride()[:2],
            float(scale), float(softcap), int(swa_window), int(attn_chunk),
            _cuda.stream_ptr(q))
    return rc, out


def flash_attention_decode_q8(q, k_q, k_s, v_q, v_s, q_pos0, kv_len, *,
                              scale: float, softcap: float = 0.0,
                              swa_window: int = 0, attn_chunk: int = 0,
                              sinks=None):
    """Decode / short-chunk attention (T <= 16) over a quantized layer slab
    in any of the four codecs, told apart by the codes' dtype and width.
    CUDA kernel ``csrc/flash_attention_decode_q.cu``, which replaces the
    Pallas kernel flash_attention.py:flash_attention_decode_q8 of the JAX
    package. It is bound by the stored bytes of the filled rows; it runs
    ``flash_attention_decode``'s split-K frame (``decode_split_plan``, one
    launch, the splits merged in order by the last block) with a tile
    loader that stages the raw rows by cp.async and unpacks them to bf16
    after the wait. It raises where the TPU kernel returned None (packed
    codecs need equal k and v head dims that are multiples of 32)."""
    if q.device.type == "cpu":
        return attention_quant_ref(q, k_q, k_s, v_q, v_s, q_pos0, kv_len,
                                   scale=scale, softcap=softcap,
                                   swa_window=swa_window,
                                   attn_chunk=attn_chunk, sinks=sinks)
    _cuda.require(q.shape[1] <= DECODE_MAX_T,
                  f"flash_attention_decode_q8: T={q.shape[1]} > {DECODE_MAX_T}")
    rc, out = _launch_quant("ik_flash_attention_decode_q", "flash_attention_decode_q",
                            kv_codec_of(k_q, q.shape[-1]), q, k_q, k_s, v_q, v_s,
                            q_pos0, kv_len, scale, softcap, swa_window, attn_chunk,
                            sinks, split=True)
    flash_attention_decode_q8.launches += 1
    _cuda.check(rc, "flash_attention_decode_q8")
    return out


flash_attention_decode_q8.launches = 0


# Query heads of one GQA group that a block of kernel 6 takes where the
# shape allows it: each key tile is unpacked once for both. It walks long
# key ranges faster than a block of one head, and a block of four (16 warps)
# spilled at the 128 registers a thread such a block allows (PERF.md).
Q8_HEADS = 2


def prefill_q8_heads(h: int, hkv: int, dmax: int) -> int:
    """The query heads a block of kernel 6 takes: Q8_HEADS where it divides
    the group H / Hkv and the head dims are at most 128 (at 256 the block's
    registers hold one head's warps only), else 1."""
    n = Q8_HEADS
    return n if (h // hkv) % n == 0 and dmax <= 128 else 1


def flash_attention_q8(q, k_q, k_s, v_q, v_s, q_pos0, kv_len, *, scale: float,
                       softcap: float = 0.0, swa_window: int = 0,
                       attn_chunk: int = 0, sinks=None):
    """Prefill attention (any T) over an int8 cache with per-(row, head)
    scales. CUDA kernel ``csrc/flash_attention_q8.cu``, which replaces the
    Pallas kernel flash_attention.py:flash_attention_q8 of the JAX package.
    Bound by bf16 tensor-core work on the live part of the causal score
    matrix; ``flash_attention``'s frame (``csrc/fa_prefill.cuh``) fed by a
    two-stage cp.async ring of the raw int8 rows and their scales, each
    tile unpacked once to row-major bf16 (K the codes, V bf16(code *
    scale)) for the ``prefill_q8_heads`` heads of its block."""
    if q.device.type == "cpu":
        return attention_quant_ref(q, k_q, k_s, v_q, v_s, q_pos0, kv_len,
                                   scale=scale, softcap=softcap,
                                   swa_window=swa_window,
                                   attn_chunk=attn_chunk, sinks=sinks)
    codec = kv_codec_of(k_q, q.shape[-1])
    _cuda.require(codec == "q8" and k_q.dtype == torch.int8,
                  f"flash_attention_q8: int8 (q8) codes only, got {codec} "
                  f"{k_q.dtype}")
    rc, out = _launch_quant("ik_flash_attention_q8", "flash_attention_q8", codec,
                            q, k_q, k_s, v_q, v_s, q_pos0, kv_len, scale, softcap,
                            swa_window, attn_chunk, sinks)
    flash_attention_q8.launches += 1
    _cuda.check(rc, "flash_attention_q8")
    return out


flash_attention_q8.launches = 0
