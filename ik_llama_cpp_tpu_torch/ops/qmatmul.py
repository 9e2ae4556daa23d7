"""Quantized matmuls: the int8 supergroup GEMM, the planar dequant GEMM and
its 4-bit packed form.

Each wrapper takes its plain torch version for tensors on the CPU and
launches its CUDA kernel (``csrc/``) for tensors on the card; there is no
fallback from one to the other. ``qmatmul_ref``, ``qmatmul_i8_ref`` and
``quantize_activations`` carry the numerics contracts of the JAX package's
``ops/qmatmul.py``; ``requant_supergroup`` and ``pack_int4`` are its numpy
load-time recodes, and ``requant_rows`` is ``requant_supergroup`` in torch
on the load's device, bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _cuda

SUPERGROUP = 256


# --------------------------------------------------------------------------
# planar form: int8 codes (K, N) x bf16 group scales (K/G, N) [+ bias]
# --------------------------------------------------------------------------

def _dequant_bf16(codes, scale, bias, group):
    w = codes.to(torch.bfloat16) * torch.repeat_interleave(
        scale.to(torch.bfloat16), group, dim=0)
    if bias is not None:
        w = w + torch.repeat_interleave(bias.to(torch.bfloat16), group, dim=0)
    return w


def qmatmul_ref(x, codes, scale, bias=None, group: int = 32):
    """Plain version: x (M, K) @ dequant(codes (K, N), scale (K/G, N)) -> f32.

    The dequant chain runs in bf16 (codes are exact in bf16; scale and bias
    round once), the products of bf16 operands sum in float32."""
    w = _dequant_bf16(codes, scale, bias, group)
    return x.to(torch.bfloat16).float() @ w.float()


# The M <= 16 kernel (qmatmul_gemv_kernel): a block's 4 warps share 128
# output columns, each with its own range of whole groups of K; the blocks
# of a cluster (the K split) take further ranges.
GEMV_MAX_M = 16
GEMV_WARPS = 4
GEMV_COLS = 128
GEMV_MAX_SPLITS = 8        # the portable thread-block cluster size
GEMV_BLOCKS = 224          # blocks a launch aims at: ~1.7 per H100 SM (see gemv_plan)
SMEM_LIMIT = 48 * 1024     # static shared memory a block may use


def gemv_plan(m: int, n: int, k: int, group: int) -> dict:
    """The launch of the M <= 16 kernel for an (m, k) x (k, n) product:
    column tiles of 128, the K split (blocks of a cluster: as many as keep
    the launch at or under GEMV_BLOCKS, at most 8, and no more than leave
    each warp a group), and the shared memory of the block's fixed-order sum
    of its warps' (m tiles x 8, 128) float partials. ~1.7 blocks an SM is
    where chip_smoke.py's split sweep (phase 3) is fastest on the H100: more
    blocks add partial sums to add and shorter K ranges, fewer leave SMs
    idle. A pure function of the shapes: the planar and the pair form of
    one product get one plan, so they add their partial sums in one order."""
    if not (1 <= m <= GEMV_MAX_M and group % 16 == 0 and k % group == 0):
        raise ValueError(f"qmatmul: M <= {GEMV_MAX_M} needs group % 16 == 0 and "
                         f"K % group == 0 (M {m}, K {k}, group {group})")
    tiles = -(-n // GEMV_COLS)
    splits = gemv_splits(tiles, k // group, GEMV_BLOCKS)
    m_tiles = 1 if m <= 8 else 2
    return {"tiles": tiles, "splits": splits, "m_tiles": m_tiles,
            "smem": GEMV_WARPS * m_tiles * 8 * GEMV_COLS * 4}


def gemv_splits(tiles: int, units: int, blocks: int) -> int:
    """The K split of an M <= 16 kernel: as many blocks a cluster as keep
    the launch of ``tiles`` column tiles at or under ``blocks``, at most
    GEMV_MAX_SPLITS, and no more than leave each warp one of K's ``units``."""
    return max(1, min(GEMV_MAX_SPLITS, blocks // tiles, units // GEMV_WARPS))


def gemv_k_ranges(k: int, group: int, splits: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) of K that warp i of a cluster (block i // 4, warp
    i % 4) sums, as the kernel computes them: whole groups, in order."""
    ng, nw = k // group, splits * GEMV_WARPS
    return [(i * ng // nw * group, (i + 1) * ng // nw * group) for i in range(nw)]


# The M > 16 kernels of the planar form and of its 4-bit packed form
# (qmatmul_wgmma_kernel, qmatmul4_wgmma_kernel, csrc/dq_wgmma.cuh): output
# tiles of TILED_TN weight columns (two warpgroups of 64) by ``tm`` tokens,
# 64-deep K stages, one persistent block an SM.
TILED_TN = 128
TILED_BK = 64
# a tile's time by its tokens, over a 256-token tile's: what the plan
# weighs rounds of the grid with (chip_smoke.py phase 3's width sweep)
TILED_TILE_COST = {256: 1.0, 128: 0.67, 64: 0.6}


def tiled_plan(m: int, n: int, k: int, group: int, sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of kernels D and 15 at M > 16, a pure function of the
    shapes and the card's SM count, chosen before the launch.

    {"kernel": "wgmma"}: output tiles of TILED_TN columns by ``tm`` tokens
    (tile i at tokens (i % m_tiles) * tm and columns (i // m_tiles) *
    TILED_TN) and a persistent grid of ``blocks`` that walks them, block b
    taking tiles b, b + blocks, ... Each tile sums the whole of K in order:
    K is never split, so a call repeats bit for bit. ``tm`` is the width
    whose rounds of the grid (tiles over SMs, rounded up) cost least at
    TILED_TILE_COST, the widest on a tie. It needs N % 16 == 0 (TMA
    addresses 16-byte code rows), group % 16 == 0 with group dividing 64 or
    64 dividing group (a stage's scale rows are one TMA box), and K %
    group == 0.

    {"kernel": "tiled"} for the other shapes at M > 16: the first port's
    mma.sync kernels (``qmatmul_kernel``, ``qmatmul4_kernel``), by name."""
    if m <= GEMV_MAX_M:
        raise ValueError(f"qmatmul: the M > {GEMV_MAX_M} kernels take M > {GEMV_MAX_M} (M {m})")
    if not (n > 0 and n % 16 == 0 and group > 0 and group % 16 == 0
            and (TILED_BK % group == 0 or group % TILED_BK == 0)
            and k > 0 and k % group == 0 and sms > 0):
        return {"kernel": "tiled"}
    n_tiles = -(-n // TILED_TN)

    def cost(tm):
        return -(-(-(-m // tm) * n_tiles) // sms) * TILED_TILE_COST[tm]

    tm = min(TILED_TILE_COST, key=cost)         # dict order: the widest wins a tie
    m_tiles = -(-m // tm)
    tiles = m_tiles * n_tiles
    return {"kernel": "wgmma", "tm": tm, "tn": TILED_TN, "m_tiles": m_tiles,
            "n_tiles": n_tiles, "tiles": tiles, "blocks": min(tiles, sms)}


def _launch_plan(m, n, k, group, x):
    """(splits, tile_m) of an ``ik_qmatmul`` / ``ik_qmatmul_pair`` call:
    the K split at M <= 16, the wgmma kernel's grid and tile tokens above
    (tile_m 0: the mma.sync tiled kernel)."""
    if m <= GEMV_MAX_M:
        return gemv_plan(m, n, k, group)["splits"], 0
    plan = tiled_plan(m, n, k, group, _cuda.sm_count(x))
    return (plan["blocks"], plan["tm"]) if plan["kernel"] == "wgmma" else (1, 0)


def qmatmul(x, codes, scale, bias=None, *, group: int = 32):
    """(M, K) x int8 (K, N) -> f32 (M, N); scale/bias (K/G, N), bf16 (as the
    loaders store them) or float32, which the kernel rounds to bf16.

    CUDA kernels in ``csrc/qmatmul.cu``, which replace the Pallas kernel
    ops/qmatmul.py:qmatmul of the JAX package. At M <= 16 (decode) the
    product is bound by the weight bytes (~1.06 a weight): a GEMV-shaped
    kernel reads every code once in 16-byte loads with several K steps in
    flight and no barrier in the K sweep, splits K over the warps of a
    block and the blocks of a cluster (``gemv_plan``) and adds the partial
    sums in a fixed order, so a call repeats bit for bit. It needs
    group % 16 == 0. Above 16 rows the product is bound by bf16
    tensor-core work: warpgroup MMAs with the weights as the A operand,
    dequantized in registers from TMA-loaded code tiles, x by TMA as the B
    operand, a persistent grid of 128-column tiles (``tiled_plan``); the
    shapes it does not take run the first port's mma.sync tiled kernel.
    The wgmma form needs the weights 16-byte aligned."""
    if x.device.type == "cpu":
        return qmatmul_ref(x, codes, scale, bias, group=group)
    m, k = x.shape
    k2, n = codes.shape
    _cuda.require(k == k2 and k % group == 0, f"qmatmul: shapes {x.shape} {codes.shape} group {group}")
    _cuda.require(scale.shape == (k // group, n), f"qmatmul: scale {tuple(scale.shape)}")
    _cuda.require(codes.dtype == torch.int8 and codes.is_contiguous(), "qmatmul: codes must be contiguous int8")
    _cuda.require(scale.dtype in (torch.bfloat16, torch.float32) and scale.is_contiguous(),
                  "qmatmul: scale must be contiguous bf16 or float32")
    if bias is not None:
        _cuda.require(bias.dtype == scale.dtype and bias.is_contiguous()
                      and bias.shape == scale.shape, "qmatmul: bias must match scale")
    for t in (codes, scale, bias):
        _cuda.require(t is None or t.device == x.device, "qmatmul: operands on different devices")
    splits, tile_m = _launch_plan(m, n, k, group, x)
    xb = _gemv_operand(x, codes, scale, bias)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("qmatmul", "ik_qmatmul",
                        [_cuda.P] * 4 + [_cuda.I, _cuda.P] + [_cuda.I] * 6 + [_cuda.P])
    rc = fn(xb.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            int(scale.dtype == torch.bfloat16), out.data_ptr(),
            m, n, k, group, splits, tile_m, _cuda.stream_ptr(x))
    if tile_m:
        qmatmul.wgmma_launches += 1
    qmatmul.launches += 1
    _cuda.check(rc, "qmatmul")
    return out


def _gemv_operand(x, *weights):
    """x as contiguous bf16 at a 16-byte aligned address (a copy of a view
    that starts elsewhere); the weights must be aligned already: the M <= 16
    kernel reads them in 16-byte loads."""
    _cuda.require(_cuda.aligned16(*weights), "qmatmul: weights must be 16-byte aligned")
    xb = x.to(torch.bfloat16).contiguous()
    return xb if _cuda.aligned16(xb) else xb.clone()


qmatmul.launches = 0      # kernel launches, counted where they happen
qmatmul.wgmma_launches = 0   # ... of them, the wgmma form's (M > 16)


# --------------------------------------------------------------------------
# 4-bit packed planar form: 4-bit-class formats whose planar codes take at
# most 16 distinct values are re-packed at load into indices, two a byte
# along K: packed (K/2, N) uint8 = idx[2i] | idx[2i+1] << 4, half the weight
# bytes of the int8 planar layout. A static 16-entry codebook maps an index
# to its code value; without one the value is idx - 8.
# --------------------------------------------------------------------------

def pack_int4(codes: np.ndarray):
    """Planar int8 codes (K, N) -> (packed (K/2, N) uint8, lut16 | None), or
    None when the tensor is not packable (more than 16 distinct values, or
    odd K). A dense [-8, 7] range (more than 12 of its values present) is
    stored as idx = code + 8 with no codebook; anything else gets a sorted
    codebook padded with its largest value."""
    k = codes.shape[0]
    if k % 2:
        return None
    vals = np.unique(codes)
    if vals.size > 16:
        return None
    if vals.min() >= -8 and vals.max() <= 7 and vals.size > 12:
        idx = (codes.astype(np.int16) + 8).astype(np.uint8)
        lut = None
    else:
        lut16 = np.full(16, float(vals[-1]), np.float32)
        lut16[:vals.size] = vals.astype(np.float32)
        idx = np.searchsorted(vals, codes).astype(np.uint8)
        lut = tuple(float(v) for v in lut16)
    packed = (idx[0::2] | (idx[1::2] << 4)).astype(np.uint8)
    return packed, lut


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) uint8 -> the (K, N) indices in [0, 16) as int64."""
    k2, n = packed.shape
    p = packed.to(torch.int64)
    return torch.stack([p & 0x0F, p >> 4], dim=1).reshape(2 * k2, n)


def _dequant4_bf16(packed, scale, bias, group, lut16):
    idx = unpack_int4(packed)
    if lut16 is None:
        w = (idx - 8).to(torch.bfloat16)
    else:
        w = torch.tensor(lut16, dtype=torch.float32,
                         device=packed.device)[idx].to(torch.bfloat16)
    w = w * torch.repeat_interleave(scale.to(torch.bfloat16), group, dim=0)
    if bias is not None:
        w = w + torch.repeat_interleave(bias.to(torch.bfloat16), group, dim=0)
    return w


def qmatmul4_ref(x, packed, scale, bias=None, *, group: int = 32, lut16=None):
    """Plain version: x (M, K) @ dequant(packed (K/2, N)) -> f32, with
    ``qmatmul_ref``'s numerics: bf16(value) * bf16(scale) rounded to bf16,
    + bf16(bias) rounded to bf16, bf16 x, float32 sums."""
    w = _dequant4_bf16(packed, scale, bias, group, lut16)
    return x.to(torch.bfloat16).float() @ w.float()


# The M <= 16 kernel of the packed form (qmatmul4_gemv_kernel) has kernel
# D's shape (4 warps on 128 columns, a cluster of 1-8 blocks splitting K)
# and steps of 32 K rows (16 packed rows, 4 a lane): a warp's K range is a
# whole number of lcm(group, 32)-row units, whole groups and whole steps.
GEMV4_STEP = 32
GEMV4_BLOCKS = 224         # blocks a launch aims at, as for kernel D (see gemv4_plan)
GEMV4_WAVE = 4 * 132       # blocks of one wave at M <= 8: 4 an H100 SM (127 registers)


def gemv4_plan(m: int, n: int, k: int, group: int) -> dict:
    """The launch of kernel 15 for an (m, k) x (k, n) product, a pure
    function of the shapes, chosen before the launch. {"kernel": "tiled"}
    where the M <= 16 kernel does not apply (M > 16, a group that is not a
    multiple of 16, or K not a whole number of units); else {"kernel":
    "gemv"} with the unit of K a warp's range is made of (lcm(group, 32)
    rows), the column tiles of 128, the K split (blocks of a cluster: as
    many as keep the launch at or under GEMV4_BLOCKS, at most 8, and no more
    than leave each warp a unit: ``gemv_plan``'s rule for kernel D, on
    units), the m tiles and the static shared memory (the warps' partials,
    and the 1 KB codebook table, which is counted always).

    One exception, from chip_smoke.py's split sweep on the H100: at M <= 8,
    where that rule leaves one block a tile (N > 14336), two blocks a tile
    ran faster (M=1 K=4096 N=28672) as long as the launch stays within one
    wave of four blocks an SM; at M > 8 (164 registers, three blocks an SM)
    they ran slower."""
    unit = math.lcm(group, GEMV4_STEP)
    if not (1 <= m <= GEMV_MAX_M and group % 16 == 0 and k % unit == 0):
        return {"kernel": "tiled"}
    tiles = -(-n // GEMV_COLS)
    units = k // unit
    splits = gemv_splits(tiles, units, GEMV4_BLOCKS)
    m_tiles = 1 if m <= 8 else 2
    if m_tiles == 1 and splits == 1 and 2 * tiles <= GEMV4_WAVE and units >= 2 * GEMV_WARPS:
        splits = 2
    return {"kernel": "gemv", "unit": unit, "tiles": tiles, "splits": splits,
            "m_tiles": m_tiles, "smem": GEMV_WARPS * m_tiles * 8 * GEMV_COLS * 4 + 1024}


def qmatmul4(x, packed, scale, bias=None, *, group: int = 32, lut16=None):
    """(M, K) x 4-bit packed (K/2, N) -> f32 (M, N); scale/bias bf16
    (K/G, N); lut16: 16 codebook values or None for idx - 8.

    CUDA kernels in ``csrc/qmatmul4.cu``, which replace the Pallas kernel
    ops/qmatmul.py:qmatmul4 of the JAX package; ``gemv4_plan`` picks one
    before the launch. At M <= 16 (decode) the product is bound by the
    weight bytes (half a byte a weight): kernel D's GEMV shape (16-byte
    loads, steps in flight in registers, K split over the warps of a block
    and the blocks of a cluster, partial sums added in a fixed order, so a
    call repeats bit for bit) with the nibble unpack in registers. It needs
    group % 16 == 0 and K a whole number of lcm(group, 32) rows. Above 16
    rows ``tiled_plan`` picks ``qmatmul``'s wgmma design, bound by bf16
    tensor-core work, with the GEMV kernel's unpack on each thread's A
    fragment; the shapes neither takes run the first port's mma.sync
    tiled kernel (both nibbles of a byte into neighbouring K positions)."""
    if x.device.type == "cpu":
        return qmatmul4_ref(x, packed, scale, bias, group=group, lut16=lut16)
    m, k = x.shape
    k2, n = packed.shape
    _cuda.require(k == 2 * k2 and k % group == 0 and group % 2 == 0,
                  f"qmatmul4: shapes {tuple(x.shape)} {tuple(packed.shape)} group {group}")
    _cuda.require(scale.shape == (k // group, n), f"qmatmul4: scale {tuple(scale.shape)}")
    _cuda.require(packed.dtype == torch.uint8 and packed.is_contiguous(),
                  "qmatmul4: packed must be contiguous uint8")
    _cuda.require(scale.dtype == torch.bfloat16 and scale.is_contiguous(),
                  "qmatmul4: scale must be contiguous bf16")
    if bias is not None:
        _cuda.require(bias.dtype == torch.bfloat16 and bias.is_contiguous()
                      and bias.shape == scale.shape, "qmatmul4: bias must match scale")
    for t in (packed, scale, bias):
        _cuda.require(t is None or t.device == x.device, "qmatmul4: operands on different devices")
    _cuda.require(lut16 is None or len(lut16) == 16, "qmatmul4: lut16 must hold 16 values")
    splits, unit, tile_m = 0, 0, 0
    plan = gemv4_plan(m, n, k, group)
    if plan["kernel"] == "gemv":
        splits, unit = plan["splits"], plan["unit"]
        xb = _gemv_operand(x, packed, scale, bias)
    else:
        if m > GEMV_MAX_M:
            plan = tiled_plan(m, n, k, group, _cuda.sm_count(x))
            if plan["kernel"] == "wgmma":
                splits, tile_m = plan["blocks"], plan["tm"]
        xb = _gemv_operand(x, packed, scale, bias) if tile_m else x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lut = None if lut16 is None else (ctypes.c_float * 16)(*lut16)
    fn = _cuda.function("qmatmul4", "ik_qmatmul4",
                        [_cuda.P] * 5 + [_cuda.I] * 4
                        + [ctypes.POINTER(ctypes.c_float)] + [_cuda.I] * 3 + [_cuda.P])
    rc = fn(xb.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, group, lut, splits, unit, tile_m, _cuda.stream_ptr(x))
    if tile_m:
        qmatmul4.wgmma_launches += 1
    qmatmul4.launches += 1
    _cuda.check(rc, "qmatmul4")
    return out


qmatmul4.launches = 0
qmatmul4.wgmma_launches = 0


# --------------------------------------------------------------------------
# int8 x int8 with supergroup-256 corrections
# --------------------------------------------------------------------------

def requant_supergroup(codes: np.ndarray, scale: np.ndarray,
                       group: int = 32):
    """Planar (int8 codes (K,N), f32/bf16 scales (K/G,N)) -> supergroup int8.

    Returns (q8 (K, N) int8, sw (K/SG, N) f32). Exact values w = s*q are
    re-quantized against the per-supergroup absmax; error <= S/254 — far
    below the 4/5/6-bit quantization step the codes came from."""
    k, n = codes.shape
    w = codes.astype(np.float32) * np.repeat(
        np.asarray(scale, np.float32), group, axis=0)
    wg = w.reshape(k // SUPERGROUP, SUPERGROUP, n)
    s = np.abs(wg).max(axis=1) / 127.0            # (K/SG, N)
    s_safe = np.where(s > 0, s, 1.0)
    q8 = np.rint(wg / s_safe[:, None, :]).astype(np.int8).reshape(k, n)
    return q8, s.astype(np.float32)


def requant_rows(codes: np.ndarray, scale: np.ndarray, group: int, device,
                 chunk: int = 8192):
    """``requant_supergroup`` on rows, in torch on ``device``: planar codes
    (R, K) int8 and scales (R, K/group) -> (int8 (R, K), f32 (R, K/256))
    tensors on ``device``, the transposes of requant_supergroup's results bit
    for bit (the same float32 products, absmax, true divisions and round
    half to even). On the card it takes a load's recode off the host; rows
    go over in chunks of ``chunk`` to bound the float32 intermediates."""
    r, k = codes.shape
    q8 = torch.empty((r, k), dtype=torch.int8, device=device)
    sw = torch.empty((r, k // SUPERGROUP), dtype=torch.float32, device=device)
    for lo in range(0, r, chunk):
        c = torch.from_numpy(np.ascontiguousarray(codes[lo:lo + chunk])).to(device)
        s = torch.from_numpy(np.ascontiguousarray(scale[lo:lo + chunk], np.float32)).to(device)
        wg = (c.float() * s.repeat_interleave(group, dim=1)).reshape(
            c.shape[0], k // SUPERGROUP, SUPERGROUP)
        sg = true_div(wg.abs().amax(dim=2), 127.0)
        safe = torch.where(sg > 0, sg, torch.ones_like(sg))
        q8[lo:lo + chunk] = torch.round(wg / safe[..., None]).to(torch.int8).reshape(-1, k)
        sw[lo:lo + chunk] = sg
    return q8, sw


_DIVISORS: dict = {}


def true_div(x, c: float):
    """x / c as a float32 division on every device. On the card torch turns
    a division by a Python scalar into a multiplication by its rounded
    reciprocal, one float32 ulp apart at times; a tensor divisor (made once
    per value and device) divides."""
    key = (c, str(x.device))
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.tensor(c, dtype=torch.float32, device=x.device)
    return x / d


def quantize_activations(x, sg: int = SUPERGROUP):
    """x (M, K) -> (int8 (M, K), f32 (M, K/sg)) per (row, supergroup).

    Bit for bit the JAX package's quantize_activations: float32 absmax / 127,
    float32 division, round half to even, clip to [-127, 127]."""
    m, k = x.shape
    xf = x.float().reshape(m, k // sg, sg)
    s = true_div(torch.amax(torch.abs(xf), dim=2), 127.0)
    s_safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(xf / s_safe[:, :, None]), -127, 127)
    return q.to(torch.int8).reshape(m, k), s


def qmatmul_i8_ref(x_q, x_s, codes, sw):
    """Plain version: exact integer dot per supergroup + f32 corrections.

    Every partial sum of 256 int8 x int8 products is an integer below 2^24,
    so the float32 matmul per supergroup is exact (with TF32 off on the
    card)."""
    m, k = x_q.shape
    nsg = k // SUPERGROUP
    xg = x_q.float().reshape(m, nsg, SUPERGROUP)
    wg = codes.float().reshape(nsg, SUPERGROUP, -1)
    xs, sws = x_s.float(), sw.float()
    out = torch.zeros((m, wg.shape[2]), dtype=torch.float32, device=x_q.device)
    for g in range(nsg):
        out += (xg[:, g] @ wg[g]) * xs[:, g:g + 1] * sws[g][None, :]
    return out


# The M <= 16 kernel (qmatmul_i8_gemv_kernel): a block's 4 warps share 32
# output columns (two 16-column mma tiles) and take consecutive ranges of
# 64-deep K steps; the blocks of a cluster (the K split) take further
# ranges. A range may cut a supergroup: each part gets its own correction.
GEMV_I8_COLS = 32
GEMV_I8_STEP = 64
GEMV_I8_MIN_STEPS = 2      # the ring's depth: a warp with fewer steps gains nothing from a split
GEMV_I8_BLOCKS = 256       # blocks a launch aims at: ~2 an H100 SM (see gemv_i8_plan)


def gemv_i8_plan(m: int, n: int, k: int) -> dict:
    """The launch of kernel A at M <= 16 for an (m, k) x (k, n) product, a
    pure function of the shapes: column tiles of 32 and the K split
    (``gemv_splits`` on units of GEMV_I8_MIN_STEPS 64-deep steps, aiming at
    GEMV_I8_BLOCKS blocks). Warp i of a cluster sums the steps
    ``gemv_k_ranges(k, GEMV_I8_STEP, splits)[i]``. ~2 blocks an SM is where
    chip_smoke.py's split sweep (phase 3) is fastest on the H100 (N 2048 and
    4096 at K 2048-14336): more blocks add partial sums and cluster
    scheduling, fewer leave bytes out of flight; from 160 tiles up one block
    a tile is fastest.

    Where a launch has few column tiles (N 2048-6144 at K 2048-5632: 64-192
    tiles), the split is what fills the card: K = 2048 has only 8
    supergroups, so the ranges are cut in 64-deep steps, not supergroups,
    and a supergroup cut between two warps is corrected in two exact parts.
    Narrowing the column tile instead would leave half of each mma's 16
    rows empty."""
    if not (1 <= m <= GEMV_MAX_M and k > 0 and k % SUPERGROUP == 0 and n > 0):
        raise ValueError(f"qmatmul_i8: the M <= {GEMV_MAX_M} kernel needs K % {SUPERGROUP} "
                         f"== 0 (M {m}, K {k}, N {n})")
    tiles = -(-n // GEMV_I8_COLS)
    steps = k // GEMV_I8_STEP
    return {"tiles": tiles, "splits": gemv_splits(tiles, steps // GEMV_I8_MIN_STEPS,
                                                  GEMV_I8_BLOCKS), "steps": steps}


# The M > 16 kernel (qmatmul_i8_wgmma_kernel): 128-row output tiles (two
# warpgroups of 64) by 64, 128 or 192 columns, 128-deep K stages, one
# persistent block an SM.
TILED_I8_BM = 128
# a tile's time by its columns, over a 128-column tile's: what the plan
# weighs rounds of the grid with (chip_smoke.py phase 3's width sweep on
# the H100: 0.69 and 1.29-1.43, PERF.md)
TILED_I8_TILE_COST = {128: 1.0, 192: 1.4, 64: 0.7}


def tiled_i8_plan(m: int, n: int, k: int, sms: int = _cuda.DEFAULT_SMS) -> dict:
    """The launch of kernel A at M > 16, a pure function of the shapes and
    the card's SM count: output tiles of TILED_I8_BM rows by ``bn``
    columns (tile i at rows (i % m_tiles) * BM and columns (i // m_tiles) *
    bn) and a persistent grid of ``blocks`` that walks them, block b taking
    tiles b, b + blocks, ... Each tile sums the whole of K in supergroup
    order: K is never split, so the float corrections keep their order.
    ``bn`` is the width whose rounds of the grid (tiles over SMs, rounded
    up) cost least at TILED_I8_TILE_COST, 128 on a tie: wider tiles where
    128 columns leave most of a last round idle (N 6144: 192 tiles on 132
    SMs), narrower where they would leave half the card idle."""
    if not (m > GEMV_MAX_M and n > 0 and k > 0 and k % SUPERGROUP == 0 and sms > 0):
        raise ValueError(f"qmatmul_i8: the M > {GEMV_MAX_M} kernel needs K % {SUPERGROUP} "
                         f"== 0 (M {m}, K {k}, N {n})")
    m_tiles = -(-m // TILED_I8_BM)

    def cost(bn):
        return -(-(m_tiles * -(-n // bn)) // sms) * TILED_I8_TILE_COST[bn]

    bn = min(TILED_I8_TILE_COST, key=cost)      # dict order: 128 first wins a tie
    n_tiles = -(-n // bn)
    tiles = m_tiles * n_tiles
    return {"bm": TILED_I8_BM, "bn": bn, "m_tiles": m_tiles, "n_tiles": n_tiles,
            "tiles": tiles, "blocks": min(tiles, sms)}


def qmatmul_i8(x_q, x_s, codes, sw):
    """int8 (M, K) @ int8 (K, N) -> f32 (M, N) with supergroup corrections.

    x_s: f32 (M, K/256); sw: f32 (K/256, N); K % 256 == 0. On the card
    ``codes`` must be the (K, N) transposed view of a contiguous (N, K)
    tensor, which is how QLinearI8 stores it.

    CUDA kernels in ``csrc/qmatmul_i8.cu``, which replace the Pallas kernel
    ops/qmatmul.py:qmatmul_i8_mxu and the XLA qmatmul_i8 of the JAX package
    at every M. Decode (M <= 16) is bound by the weight bytes: a GEMV-shaped
    kernel builds the mma operands in registers from 16-byte loads of the
    weight rows, keeps several K steps and their supergroup corrections in
    flight with no barrier in the K sweep, splits K over the warps of a
    block and the blocks of a cluster (``gemv_i8_plan``) and adds the
    partial sums in a fixed order, so a call repeats bit for bit. Prefill
    is bound by int8 tensor-core work: warpgroup MMAs (wgmma m64nNk32) on
    128-row tiles of 64-192 columns fed by TMA through a ring of 128-deep
    stages, a persistent grid (``tiled_i8_plan``), each supergroup's exact
    int32 sums folded into the float result in supergroup order."""
    if x_q.device.type == "cpu":
        return qmatmul_i8_ref(x_q, x_s, codes, sw)
    m, k = x_q.shape
    k2, n = codes.shape
    _cuda.require(k == k2 and k % SUPERGROUP == 0, f"qmatmul_i8: shapes {x_q.shape} {codes.shape}")
    _cuda.require(x_q.dtype == torch.int8 and x_q.is_contiguous(), "qmatmul_i8: x_q must be contiguous int8")
    _cuda.require(codes.dtype == torch.int8 and codes.t().is_contiguous(),
                  "qmatmul_i8: codes must be the transpose of a contiguous (N, K) int8 tensor")
    _cuda.require(x_s.dtype == torch.float32 and x_s.is_contiguous()
                  and x_s.shape == (m, k // SUPERGROUP), "qmatmul_i8: x_s must be contiguous f32 (M, K/256)")
    _cuda.require(sw.dtype == torch.float32 and sw.is_contiguous()
                  and sw.shape == (k // SUPERGROUP, n), "qmatmul_i8: sw must be contiguous f32 (K/256, N)")
    for t in (x_s, codes, sw):
        _cuda.require(t.device == x_q.device, "qmatmul_i8: operands on different devices")
    _cuda.require(_cuda.aligned16(x_q, codes), "qmatmul_i8: int8 operands must be 16-byte aligned")
    if m <= GEMV_MAX_M:
        splits, tile_n = gemv_i8_plan(m, n, k)["splits"], 0
    else:
        plan = tiled_i8_plan(m, n, k, _cuda.sm_count(x_q))
        splits, tile_n = plan["blocks"], plan["bn"]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    fn = _cuda.function("qmatmul_i8", "ik_qmatmul_i8",
                        [_cuda.P] * 5 + [_cuda.I] * 5 + [_cuda.P])
    rc = fn(x_q.data_ptr(), x_s.data_ptr(), codes.data_ptr(), sw.data_ptr(),
            out.data_ptr(), m, n, k, splits, tile_n, _cuda.stream_ptr(x_q))
    qmatmul_i8.launches += 1
    _cuda.check(rc, "qmatmul_i8")
    return out


qmatmul_i8.launches = 0
