"""MoE prefill: the grouped GEMMs over sorted rows (int8 supergroup and
planar) and the capacity-bucketed whole-FFN kernel.

The torch counterpart of the JAX package's ``ops/moe_qmm.py``:

* ``ragged_qmatmul_i8``: rows sorted by expert (``group_sizes`` (G,) rows
  each), int8 (M, K) against int8 (G, K, N) with supergroup corrections.
* ``ragged_qmatmul``: the same rows in bf16 against planar int8 codes with
  group scales (any group, f32 or bf16 scales), dequantized in bf16.
* ``fused_moe_prefill_i8``: the rows gathered into (G, R, K) capacity
  buckets; per live expert the whole FFN (gate/up, activation, bf16 round,
  per-(row, 256) requantization of h, down) in one launch, each expert
  split over several work items.

Layouts at the public functions are the JAX package's: codes (G, K, N),
scales (G, K/group, N), activation scales transposed. On the card the codes
must be the (G, K, N) view of a contiguous (G, N, K) tensor, as
``QuantExpertWeights`` stores them.
"""
from __future__ import annotations

import torch

from . import _cuda
from .moe_decode import (ACTIVATIONS, SMEM_LIMIT, SUPERGROUP, _act, _check_codes,
                         _check_planar, dequant_experts, requant_by_inverse,
                         sg_accumulate)

# The work items of csrc/moe_qmm_i8.cu's fused kernel (kernel 9): 64-row
# blocks of a bucket; 64 columns of FF (phase 1) or 256 of E (phase 2) an
# item; h requantized per 256 FF columns by the last of their four phase-1
# items; a ring of 128-byte-deep stages fed by TMA.
FUSED_ROWS = 64
FUSED_COLS = 256
FUSED_SWEEP = 64
FUSED_BK = 128
FUSED_MAX_DEPTH = 4
_FUSED_FIXED = 1024 + (2 * FUSED_MAX_DEPTH + 4) * 8 + 2 * 20 + 16   # alignment, barriers, queue


def _i8_rows(q, qs, codes, sw):
    """(R, K) int8 rows against one expert (K, N): f32 (R, N)."""
    acc = torch.zeros((q.shape[0], codes.shape[1]), dtype=torch.float32, device=q.device)
    for g in range(q.shape[1] // SUPERGROUP):
        acc = sg_accumulate(acc, q, qs, codes, sw, g)
    return acc


def ragged_qmatmul_i8_ref(xq, xs, codes, sw, group_sizes):
    """Plain version of kernel 10 (the JAX package's ``ragged_qmatmul_i8_ref``):
    xq int8 (M, K), xs f32 (M, K/256) -- not transposed --, codes int8
    (G, K, N), sw f32 (G, K/256, N), group_sizes (G,). Rows past
    sum(group_sizes) are computed with the last expert, as the JAX oracle
    does. Reads group_sizes back to the host (a plain version may)."""
    m = xq.shape[0]
    out = torch.empty((m, codes.shape[2]), dtype=torch.float32, device=xq.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        end = min(start + int(n), m)
        if end > start:
            out[start:end] = _i8_rows(xq[start:end], xs[start:end], codes[g], sw[g])
        start = end
    if start < m:
        out[start:] = _i8_rows(xq[start:], xs[start:], codes[-1], sw[-1])
    return out


# Kernel 10 (csrc/moe_qmm_i8.cu, ragged_i8_wgmma_kernel): sweeps of 128
# expert columns by 64 of the expert's tokens; a stage is 128 deep (two a
# supergroup).
RAGGED_I8_TN = 128
RAGGED_I8_TM = 64


def ragged_i8_plan(m: int, n: int, k: int, g: int, sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of kernel 10, a pure function of the shapes and the SM
    count, chosen before the launch (group_sizes stay on the device).

    Sweeps of RAGGED_I8_TN expert columns by RAGGED_I8_TM tokens of one
    expert (``tm``, the wgmma N dimension), ``n_tiles`` column tiles, on a
    persistent grid of ``blocks``: one an SM, or fewer where the most
    sweeps a call can have (``sweeps``: every column tile of ceil(M / tm) +
    min(G, M) token tiles) are fewer. The sweeps are numbered
    over the experts with rows in order, then column tiles, then token
    tiles, and block b takes sweeps b, b + blocks, ...
    (tests/test_torch_moe_qmm_i8_grouped.py models it). Every shape with K
    a multiple of 256 and 1 <= G <= 1024 is taken: TMA loads the tokens and
    the codes (K-contiguous rows of K bytes) and cp.async the scales, so no
    shape needs another kernel. Refuses (ValueError) any other."""
    _cuda.require(m >= 1 and n >= 1 and 1 <= g <= 1024 and k >= SUPERGROUP
                  and k % SUPERGROUP == 0 and sms > 0,
                  f"ragged_i8_plan: M={m} N={n} K={k} G={g} (K a multiple of 256, "
                  "1 <= G <= 1024)")
    tm = RAGGED_I8_TM
    n_tiles = -(-n // RAGGED_I8_TN)
    sweeps = n_tiles * (-(-m // tm) + min(g, m))
    return {"tm": tm, "tn": RAGGED_I8_TN, "n_tiles": n_tiles, "sweeps": sweeps,
            "blocks": min(sweeps, sms)}


def ragged_qmatmul_i8(xq, xst, codes, sw, group_sizes):
    """Grouped int8 GEMM: xq int8 (M, K) sorted by group, xst f32 (K/256, M),
    codes int8 (G, K, N), sw f32 (G, K/256, N), group_sizes int32 (G,) ->
    f32 (M, N). On the card rows at or past sum(group_sizes) are left
    unwritten (whatever ``torch.empty`` held); no caller reads them.

    CUDA kernel ``csrc/moe_qmm_i8.cu`` (``ragged_i8_wgmma_kernel``), which
    replaces the Pallas kernel ops/moe_qmm.py:ragged_qmatmul_i8 of the JAX
    package. Bound by the live experts' code bytes at the models' sizes:
    kernel 14's grouped sweeps (expert, 128 columns, 64 of its tokens)
    on a persistent grid that reads the group sizes on the device (no host
    sync; an empty overflow pass costs one launch), each sweep an int8
    warpgroup MMA of the expert's columns against its tokens fed by a TMA
    ring (``ragged_i8_plan``); the supergroup corrections are added in the
    plain version's order and rounding, so the live rows are its bits."""
    if xq.device.type == "cpu":
        return ragged_qmatmul_i8_ref(xq, xst.t(), codes, sw, group_sizes)
    name = "ragged_qmatmul_i8"
    m, k = xq.shape
    g, _, n = codes.shape
    _cuda.require(xq.dtype == torch.int8 and xq.is_contiguous() and _cuda.aligned16(xq),
                  f"{name}: xq must be contiguous, 16-byte aligned int8")
    _cuda.require(xst.dtype == torch.float32 and xst.shape == (k // SUPERGROUP, m),
                  f"{name}: xst must be f32 (K/256, M)")
    _check_codes(name, codes, sw, k)
    _cuda.require(group_sizes.dtype == torch.int32 and group_sizes.is_contiguous()
                  and group_sizes.shape == (g,) and g <= 1024,
                  f"{name}: group_sizes must be contiguous int32 (G,), G <= 1024")
    for t in (xst, codes, sw, group_sizes):
        _cuda.require(t.device == xq.device, f"{name}: operands on different devices")
    plan = ragged_i8_plan(m, n, k, g, _cuda.sm_count(xq))
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    fn = _cuda.function("moe_qmm_i8", "ik_ragged_qmatmul_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 4
                        + [_cuda.I] * 5 + [_cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1),
            codes.data_ptr(), sw.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            m, n, k, g, plan["blocks"], _cuda.stream_ptr(xq))
    ragged_qmatmul_i8.launches += 1
    _cuda.check(rc, name)
    return out


ragged_qmatmul_i8.launches = 0      # kernel launches, counted where they happen


def ragged_qmatmul_ref(x, codes, scale, group_sizes, *, group: int = 32):
    """Plain version of kernel 14 (the JAX package's ``ragged_qmatmul_ref``):
    x (M, K) rounded to bf16, codes int8 (G, K, N), scale f32 or bf16
    (G, K/group, N), group_sizes (G,); per group, its rows against the
    weight dequantized in bf16, float32 sums. Rows past sum(group_sizes)
    are computed with the last expert (undefined in the JAX package). Reads
    group_sizes back to the host (a plain version may)."""
    m = x.shape[0]
    xf = x.to(torch.bfloat16).float()
    out = torch.empty((m, codes.shape[2]), dtype=torch.float32, device=x.device)
    start = 0
    sizes = group_sizes.tolist()
    for g, n in enumerate(sizes):
        end = m if g == len(sizes) - 1 else min(start + int(n), m)
        if end > start:
            out[start:end] = xf[start:end] @ dequant_experts(codes[g], scale[g], group).float()
        start = end
    return out


# The wgmma form of kernel 14 (csrc/moe_qmm.cu, ragged_wgmma_kernel): sweeps
# of 128 weight columns of one expert by 64 or 128 of its rows; a stage is
# 64 deep (ops/qmatmul.TILED_BK).
RAGGED_TN = 128


def ragged_plan(m: int, n: int, k: int, g: int, group: int, scale_bytes: int,
                sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of kernel 14, a pure function of the shapes and the SM
    count, chosen before the launch (group_sizes stay on the device).

    {"kernel": "wgmma"}: sweeps of RAGGED_TN columns by ``tm`` rows of one
    expert (64 where the experts average up to 96 rows, M / G, else 128),
    ``n_tiles`` column tiles, on a persistent grid of ``blocks``: one an
    SM, or fewer where the most sweeps a call can have (``sweeps``: every
    column tile of ceil(M / tm) + min(G, M) token tiles) are fewer. The
    sweeps are numbered over the experts with rows in order, then column
    tiles, then token tiles, and block b takes sweeps b, b + blocks, ...
    (tests/test_torch_moe_qmm_grouped.py models it). It needs a group
    that is a multiple of 16 dividing 64 or divided by it, K a multiple of
    the group and of 16, and scale rows of a multiple of 16 bytes (TMA).

    {"kernel": "ragged"} for the other shapes: the first port's mma.sync
    kernel (``ragged_kernel``), by name."""
    if not (m >= 1 and n >= 1 and 1 <= g and group > 0 and group % 16 == 0
            and (64 % group == 0 or group % 64 == 0) and k % 16 == 0 and k % group == 0
            and n * scale_bytes % 16 == 0 and sms > 0):
        return {"kernel": "ragged"}
    tm = 64 if m <= 96 * g else 128
    n_tiles = -(-n // RAGGED_TN)
    sweeps = n_tiles * (-(-m // tm) + min(g, m))
    return {"kernel": "wgmma", "tm": tm, "tn": RAGGED_TN, "n_tiles": n_tiles,
            "sweeps": sweeps, "blocks": min(sweeps, sms)}


def ragged_qmatmul(x, codes, scale, group_sizes, *, group: int = 32):
    """Grouped planar GEMM: x bf16 (M, K) sorted by group, codes int8
    (G, K, N), scale f32 or bf16 (G, K/group, N), group_sizes int32 (G,)
    with sum <= M -> f32 (M, N). On the card rows at or past
    sum(group_sizes) are left unwritten (whatever ``torch.empty`` held); no
    caller reads them.

    CUDA kernel ``csrc/moe_qmm.cu``, which replaces the Pallas kernel
    ops/moe_qmm.py:ragged_qmatmul of the JAX package. Bound by the expert
    bytes at the models' sizes and by bf16 tensor-core work when the
    groups are long: the warpgroup-MMA body of the tiled planar GEMM (the
    weights the MMA's A operand, dequantized in registers from a TMA-loaded
    K-major code tile; x by TMA) over sweeps (expert, 128 columns, 64 or
    128 of its rows) that a persistent grid reads from the group sizes on
    the device (no host sync, no step table), the sweeps of one expert's
    column tile run at once by neighbouring blocks, which read its codes
    from device memory about once (``ragged_plan``). The shapes TMA cannot
    address run the first port's mma.sync kernel."""
    if x.device.type == "cpu":
        return ragged_qmatmul_ref(x, codes, scale, group_sizes, group=group)
    name = "ragged_qmatmul"
    m, k = x.shape
    g, _, n = codes.shape
    _cuda.require(x.dtype == torch.bfloat16 and x.is_contiguous() and _cuda.aligned16(x),
                  f"{name}: x must be contiguous, 16-byte aligned bf16")
    _check_planar(name, codes, scale, k, group)
    _cuda.require(group_sizes.dtype == torch.int32 and group_sizes.is_contiguous()
                  and group_sizes.shape == (g,) and g <= 1024,
                  f"{name}: group_sizes must be contiguous int32 (G,), G <= 1024")
    for t in (codes, scale, group_sizes):
        _cuda.require(t.device == x.device, f"{name}: operands on different devices")
    plan = ragged_plan(m, n, k, g, group, scale.element_size(), _cuda.sm_count(x))
    tile_m, blocks = (plan["tm"], plan["blocks"]) if plan["kernel"] == "wgmma" else (0, 1)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("moe_qmm", "ik_ragged_qmatmul",
                        [_cuda.P] * 3 + [_cuda.I] + [_cuda.P] * 2 + [_cuda.I] * 7 + [_cuda.P])
    rc = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), group_sizes.data_ptr(), out.data_ptr(),
            m, n, k, g, group, tile_m, blocks, _cuda.stream_ptr(x))
    if tile_m:
        ragged_qmatmul.wgmma_launches += 1
    ragged_qmatmul.launches += 1
    _cuda.check(rc, name)
    return out


ragged_qmatmul.launches = 0
ragged_qmatmul.wgmma_launches = 0     # the part of ``launches`` the wgmma form took


def fused_prefill_plan(capacity: int, ff: int, e: int = 1, g: int = 1,
                       sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of kernel 9, a pure function of the shapes and the SM
    count (n_live stays on the device). ``mi`` 16-row tiles of a row block
    (ceil(min(capacity, 64) / 16)); a ring stage of 128 bytes of K (2 x 64
    weight rows and 16 mi bucket rows, or 256 down rows); a phase-2 item's
    int8 h rows beside it; ``depth`` stages, as many as fit up to
    FUSED_MAX_DEPTH (deeper rings measured slower on the H100; the kernel
    needs 2); at most ``items`` work items (every slot live); ``blocks``,
    one an SM or fewer; ``counters``: the ticket, the blocks done, one a
    (slot, row block) and one a (slot, row block, FF supergroup)."""
    mi = min(4, -(-min(capacity, FUSED_ROWS) // 16))
    stage = max(2 * FUSED_SWEEP * FUSED_BK + 16 * mi * FUSED_BK, FUSED_COLS * FUSED_BK)
    region = 16 * mi * (ff + 16)
    depth = min(FUSED_MAX_DEPTH, (SMEM_LIMIT - _FUSED_FIXED - region) // stage)
    nrb = -(-capacity // FUSED_ROWS)
    nsgf = ff // SUPERGROUP
    items = g * nrb * (ff // FUSED_SWEEP + -(-e // FUSED_COLS))
    return {"mi": mi, "depth": depth, "smem": _FUSED_FIXED + region + max(depth, 0) * stage,
            "row_blocks": nrb, "items": items, "blocks": max(1, min(sms, items)),
            "counters": 2 + g * nrb * (1 + nsgf)}


def fused_prefill_items(n_live: int, capacity: int, ff: int, e: int) -> list:
    """The work items of one call in ticket order, as the kernel's producer
    decodes its tickets: (1, slot, row block, 64-column sweep of FF) for
    every live slot, then (2, slot, row block, 256-column tile of E)."""
    nrb, n_et = -(-capacity // FUSED_ROWS), -(-e // FUSED_COLS)
    nq = ff // FUSED_SWEEP
    out = []
    for tk in range(n_live * nrb * (nq + n_et)):
        if tk < n_live * nrb * nq:
            per = nrb * nq
            out.append((1, tk // per, tk % per // nq, tk % nq))
        else:
            t2, per = tk - n_live * nrb * nq, nrb * n_et
            out.append((2, t2 // per, t2 % per // n_et, t2 % n_et))
    return out


def fused_smem_bytes(ff: int, capacity: int = FUSED_ROWS) -> int:
    """Dynamic shared memory of a block of kernel 9 at ``fused_prefill_plan``'s depth."""
    return fused_prefill_plan(capacity, ff)["smem"]


def fused_prefill_fits(capacity: int, k: int, ff: int) -> bool:
    """Whether kernel 9 takes these shapes, decided from shapes alone on the
    host (the counterpart of the JAX kernel returning None): supergroup
    K and FF, a capacity that is a multiple of 8, and a ring of at least two
    stages beside the h region in shared memory (FF up to 2304 at any
    capacity). Models that fail it take the ragged chain."""
    return (k % SUPERGROUP == 0 and ff % SUPERGROUP == 0 and capacity % 8 == 0
            and capacity >= 8 and fused_prefill_plan(capacity, ff)["depth"] >= 2)


def fused_moe_prefill_i8_ref(xg, xst, eids, n_live, gate_c, gate_sw, up_c, up_sw,
                             down_c, down_sw, *, capacity: int,
                             activation: str = "silu", act_limit: float = 0.0):
    """Plain version of kernel 9: what the Pallas ``_fused_prefill_kernel``
    computes for each expert's bucket. h rounds through bf16 and is
    requantized per (row, 256) by multiplying by 1/scale (not by the
    division of ``quantize_activations``). The kernel visits only the first
    n_live eids and leaves the other experts' rows undefined; this version
    computes every expert (their buckets are zero), so it needs no host
    read of n_live."""
    del eids, n_live, capacity
    qs = xst.transpose(1, 2)                            # (G, R, K/256)
    g = torch.zeros(xg.shape[:2] + (gate_c.shape[2],), dtype=torch.float32,
                    device=xg.device)
    u = g
    for s in range(xg.shape[2] // SUPERGROUP):
        g = sg_accumulate(g, xg, qs, gate_c, gate_sw, s)
        u = sg_accumulate(u, xg, qs, up_c, up_sw, s)
    hq, hs = requant_by_inverse(_act(g, u, activation, act_limit).to(torch.bfloat16))
    acc = torch.zeros(xg.shape[:2] + (down_c.shape[2],), dtype=torch.float32,
                      device=xg.device)
    for s in range(hq.shape[2] // SUPERGROUP):
        acc = sg_accumulate(acc, hq, hs, down_c, down_sw, s)
    return acc


def fused_moe_prefill_i8(xg, xst, eids, n_live, gate_c, gate_sw, up_c, up_sw,
                         down_c, down_sw, *, capacity: int,
                         activation: str = "silu", act_limit: float = 0.0):
    """Whole-FFN prefill over capacity buckets: xg int8 (G, R, K), xst f32
    (G, K/256, R), eids int32 (G,) expert per slot (live ones first),
    n_live int32 () device scalar -> f32 (G, R, E). Only the first n_live
    eids are visited; the rows of the other experts are undefined.
    ``fused_prefill_fits`` must hold.

    CUDA kernel ``csrc/moe_qmm_i8.cu``, which replaces the Pallas kernel
    ops/moe_qmm.py:fused_moe_prefill_i8 of the JAX package. Bound by the
    live experts' code bytes: the TPU's sequential grid over n_live becomes
    a persistent grid (``fused_prefill_plan``) whose producer warps deal
    work items from a ticket counter on the device, every live slot's
    phase-1 items (gate, up and the activation of 64 FF columns, into a
    bf16 scratch; the last of a 256-column group's four items requantizes
    it into an int8 scratch, all of it in L2) before the phase-2 items (the
    down projection of 256 E columns, once its slot's h is written), each
    streamed through a TMA ring."""
    if xg.device.type == "cpu":
        return fused_moe_prefill_i8_ref(xg, xst, eids, n_live, gate_c, gate_sw, up_c,
                                        up_sw, down_c, down_sw, capacity=capacity,
                                        activation=activation, act_limit=act_limit)
    name = "fused_moe_prefill_i8"
    g, r, k = xg.shape
    f = gate_c.shape[2]
    e = down_c.shape[2]
    _cuda.require(r == capacity and fused_prefill_fits(r, k, f),
                  f"{name}: shapes R={r} K={k} FF={f} do not fit the kernel")
    _cuda.require(xg.dtype == torch.int8 and xg.is_contiguous() and _cuda.aligned16(xg),
                  f"{name}: xg must be contiguous, 16-byte aligned int8")
    _cuda.require(xst.dtype == torch.float32 and xst.shape == (g, k // SUPERGROUP, r),
                  f"{name}: xst must be f32 (G, K/256, R)")
    _cuda.require(eids.dtype == torch.int32 and eids.is_contiguous() and eids.shape == (g,)
                  and n_live.dtype == torch.int32 and n_live.numel() == 1,
                  f"{name}: eids must be int32 (G,) and n_live an int32 scalar")
    _check_codes(name, gate_c, gate_sw, k)
    _check_codes(name, up_c, up_sw, k, f)
    _check_codes(name, down_c, down_sw, f)
    _cuda.require(gate_c.shape[0] == g, f"{name}: {g} buckets for {gate_c.shape[0]} experts")
    for t in (xst, eids, n_live, gate_c, gate_sw, up_c, up_sw, down_c, down_sw):
        _cuda.require(t.device == xg.device, f"{name}: operands on different devices")
    _cuda.require(activation in ACTIVATIONS, f"{name}: activation {activation!r}")
    plan = fused_prefill_plan(r, f, e, g, _cuda.sm_count(xg))
    hb = torch.empty((g, r, f), dtype=torch.bfloat16, device=xg.device)
    hq = torch.empty((g, r, f), dtype=torch.int8, device=xg.device)
    hs = torch.empty((g, r, f // SUPERGROUP), dtype=torch.float32, device=xg.device)
    counters = _cuda.zeroed_counters(xg.device, name, plan["counters"])
    out = torch.empty((g, r, e), dtype=torch.float32, device=xg.device)
    fn = _cuda.function("moe_qmm_i8", "ik_fused_moe_prefill_i8",
                        [_cuda.P, _cuda.P] + [_cuda.I] * 3 + [_cuda.P] * 13
                        + [_cuda.I] * 6 + [_cuda.F] + [_cuda.I] * 3 + [_cuda.P])
    rc = fn(xg.data_ptr(), xst.data_ptr(), *xst.stride(), eids.data_ptr(),
            n_live.data_ptr(), gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(),
            up_sw.data_ptr(), down_c.data_ptr(), down_sw.data_ptr(), hb.data_ptr(), hq.data_ptr(),
            hs.data_ptr(), counters.data_ptr(), out.data_ptr(),
            g, r, k, f, e, ACTIVATIONS[activation], float(act_limit),
            plan["mi"], plan["depth"], plan["blocks"], _cuda.stream_ptr(xg))
    fused_moe_prefill_i8.launches += 1
    _cuda.check(rc, name)
    return out


fused_moe_prefill_i8.launches = 0
