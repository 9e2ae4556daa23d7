"""Quantized matmuls: the int8 supergroup GEMM, the planar dequant GEMM and
its 4-bit packed form.

Each wrapper takes its plain torch version for tensors on the CPU and
launches its CUDA kernel (``csrc/``) for tensors on the card; there is no
fallback from one to the other. ``qmatmul_ref``, ``qmatmul_i8_ref`` and
``quantize_activations`` carry the numerics contracts of the JAX package's
``ops/qmatmul.py``; ``requant_supergroup`` and ``pack_int4`` are its numpy
load-time recodes.
"""
from __future__ import annotations

import ctypes

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


def qmatmul(x, codes, scale, bias=None, *, group: int = 32):
    """(M, K) x int8 (K, N) -> f32 (M, N); scale/bias (K/G, N), bf16 (as the
    loaders store them) or float32, which the kernel rounds to bf16.

    CUDA kernel ``csrc/qmatmul.cu``, which replaces the Pallas kernel
    ops/qmatmul.py:qmatmul of the JAX package. It is bound by the weight
    bytes at small M and by bf16 tensor-core work at large M; it dequantizes
    one 32-deep slice of 64 columns into shared memory per step and runs
    mma.sync on it (no copy/compute overlap yet)."""
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
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("qmatmul", "ik_qmatmul",
                        [_cuda.P] * 4 + [_cuda.I, _cuda.P] + [_cuda.I] * 4 + [_cuda.P])
    rc = fn(xb.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            int(scale.dtype == torch.bfloat16), out.data_ptr(),
            m, n, k, group, _cuda.stream_ptr(x))
    qmatmul.launches += 1
    _cuda.check(rc, "qmatmul")
    return out


qmatmul.launches = 0      # kernel launches, counted where they happen


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


def qmatmul4(x, packed, scale, bias=None, *, group: int = 32, lut16=None):
    """(M, K) x 4-bit packed (K/2, N) -> f32 (M, N); scale/bias bf16
    (K/G, N); lut16: 16 codebook values or None for idx - 8.

    CUDA kernel ``csrc/qmatmul4.cu``, which replaces the Pallas kernel
    ops/qmatmul.py:qmatmul4 of the JAX package. Bound by the weight bytes
    (half a byte a weight) at small M and by bf16 tensor-core work at large
    M; ``qmatmul``'s design with the nibble unpack in front, both nibbles of
    a byte into neighbouring K positions, so x is taken whole."""
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
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lut = None if lut16 is None else (ctypes.c_float * 16)(*lut16)
    fn = _cuda.function("qmatmul4", "ik_qmatmul4",
                        [_cuda.P] * 5 + [_cuda.I] * 4 + [ctypes.POINTER(ctypes.c_float), _cuda.P])
    rc = fn(xb.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, group, lut, _cuda.stream_ptr(x))
    qmatmul4.launches += 1
    _cuda.check(rc, "qmatmul4")
    return out


qmatmul4.launches = 0


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


def qmatmul_i8(x_q, x_s, codes, sw):
    """int8 (M, K) @ int8 (K, N) -> f32 (M, N) with supergroup corrections.

    x_s: f32 (M, K/256); sw: f32 (K/256, N); K % 256 == 0. On the card
    ``codes`` must be the (K, N) transposed view of a contiguous (N, K)
    tensor, which is how QLinearI8 stores it.

    CUDA kernel ``csrc/qmatmul_i8.cu``, which replaces the Pallas kernel
    ops/qmatmul.py:qmatmul_i8_mxu and the XLA qmatmul_i8 of the JAX package
    at every M. Decode (M <= 16) is bound by the weight bytes: N/32 blocks
    stream them through a 4-stage cp.async ring. Prefill is bound by int8
    tensor-core work: 128 x 128 tiles of mma.sync.m16n8k32, one supergroup
    per stage, the float correction applied once per stage."""
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
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    fn = _cuda.function("qmatmul_i8", "ik_qmatmul_i8",
                        [_cuda.P] * 5 + [_cuda.I] * 3 + [_cuda.P])
    rc = fn(x_q.data_ptr(), x_s.data_ptr(), codes.data_ptr(), sw.data_ptr(),
            out.data_ptr(), m, n, k, _cuda.stream_ptr(x_q))
    qmatmul_i8.launches += 1
    _cuda.check(rc, "qmatmul_i8")
    return out


qmatmul_i8.launches = 0
