"""MoE prefill: the grouped GEMMs over sorted rows (int8 supergroup and
planar) and the capacity-bucketed whole-FFN kernel.

The torch counterpart of the JAX package's ``ops/moe_qmm.py``:

* ``ragged_qmatmul_i8``: rows sorted by expert (``group_sizes`` (G,) rows
  each), int8 (M, K) against int8 (G, K, N) with supergroup corrections.
* ``ragged_qmatmul``: the same rows in bf16 against planar int8 codes with
  group scales (any group, f32 or bf16 scales), dequantized in bf16.
* ``fused_moe_prefill_i8``: the rows gathered into (G, R, K) capacity
  buckets; per live expert the whole FFN (gate/up, activation, bf16 round,
  per-(row, 256) requantization of h, down) in one block.

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

# Shared-memory plan of csrc/moe_qmm_i8.cu's fused kernel (64-row blocks,
# 64-column tiles, 2 stages of 256-deep x / gate / up tiles padded to 272
# bytes a row, one 256-column bf16 staging slab of h, the int8 h of the
# block's rows padded to FF + 16 bytes, and its per-(row, 256) scales).
FUSED_ROWS = 64


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


def ragged_qmatmul_i8(xq, xst, codes, sw, group_sizes):
    """Grouped int8 GEMM: xq int8 (M, K) sorted by group, xst f32 (K/256, M),
    codes int8 (G, K, N), sw f32 (G, K/256, N), group_sizes int32 (G,) ->
    f32 (M, N). On the card rows at or past sum(group_sizes) are left
    unwritten (whatever ``torch.empty`` held); no caller reads them.

    CUDA kernel ``csrc/moe_qmm_i8.cu``, which replaces the Pallas kernel
    ops/moe_qmm.py:ragged_qmatmul_i8 of the JAX package. Bound by int8
    tensor-core work when the groups are long and by the expert bytes when
    they are short: a grid of (N tiles, row tiles) sized from M alone;
    each block finds the experts that own its rows from the group sizes on
    the device, so an empty call (the overflow pass) exits at once with no
    host sync."""
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
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    fn = _cuda.function("moe_qmm_i8", "ik_ragged_qmatmul_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 4
                        + [_cuda.I] * 4 + [_cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1),
            codes.data_ptr(), sw.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            m, n, k, g, _cuda.stream_ptr(xq))
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


def ragged_qmatmul(x, codes, scale, group_sizes, *, group: int = 32):
    """Grouped planar GEMM: x bf16 (M, K) sorted by group, codes int8
    (G, K, N), scale f32 or bf16 (G, K/group, N), group_sizes int32 (G,)
    with sum <= M -> f32 (M, N). On the card rows at or past
    sum(group_sizes) are left unwritten (whatever ``torch.empty`` held); no
    caller reads them.

    CUDA kernel ``csrc/moe_qmm.cu``, which replaces the Pallas kernel
    ops/moe_qmm.py:ragged_qmatmul of the JAX package. Bound by the expert
    bytes when the groups are short and by bf16 tensor-core work when they
    are long: kernel 10's grid of (N tiles, row tiles) and its row map read
    from the group sizes on the device (no host sync, no step table)
    around the planar GEMM's inner loop, a 64-deep slice dequantized to
    bf16 in shared memory for mma.sync, the next slice's loads in flight
    meanwhile."""
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
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("moe_qmm", "ik_ragged_qmatmul",
                        [_cuda.P] * 3 + [_cuda.I] + [_cuda.P] * 2 + [_cuda.I] * 5 + [_cuda.P])
    rc = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), group_sizes.data_ptr(), out.data_ptr(),
            m, n, k, g, group, _cuda.stream_ptr(x))
    ragged_qmatmul.launches += 1
    _cuda.check(rc, name)
    return out


ragged_qmatmul.launches = 0


def fused_smem_bytes(ff: int) -> int:
    stages = 2 * 3 * FUSED_ROWS * (SUPERGROUP + 16)
    h_slab = FUSED_ROWS * SUPERGROUP * 2
    return stages + h_slab + FUSED_ROWS * (ff + 16) + FUSED_ROWS * (ff // SUPERGROUP) * 4


def fused_prefill_fits(capacity: int, k: int, ff: int) -> bool:
    """Whether kernel 9 takes these shapes, decided from shapes alone on the
    host (the counterpart of the JAX kernel returning None): supergroup
    K and FF, a capacity that is a multiple of 8, and the int8 h of a
    64-row block in shared memory beside the tile ring (FF <= 1280).
    Models that fail it take the ragged chain."""
    return (k % SUPERGROUP == 0 and ff % SUPERGROUP == 0 and capacity % 8 == 0
            and fused_smem_bytes(ff) <= SMEM_LIMIT)


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
    live experts' code bytes: the TPU's sequential grid over n_live
    becomes a grid over (expert slot, 64-row block) whose blocks past
    n_live exit after reading n_live from device memory; each block keeps
    its int8 h in shared memory between gate/up and down."""
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
    out = torch.empty((g, r, e), dtype=torch.float32, device=xg.device)
    fn = _cuda.function("moe_qmm_i8", "ik_fused_moe_prefill_i8",
                        [_cuda.P, _cuda.P] + [_cuda.I] * 3 + [_cuda.P] * 9
                        + [_cuda.I] * 6 + [_cuda.F, _cuda.P])
    rc = fn(xg.data_ptr(), xst.data_ptr(), *xst.stride(), eids.data_ptr(),
            n_live.data_ptr(), gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(),
            up_sw.data_ptr(), down_c.data_ptr(), down_sw.data_ptr(), out.data_ptr(),
            g, r, k, f, e, ACTIVATIONS[activation], float(act_limit),
            _cuda.stream_ptr(xg))
    fused_moe_prefill_i8.launches += 1
    _cuda.check(rc, name)
    return out


fused_moe_prefill_i8.launches = 0
