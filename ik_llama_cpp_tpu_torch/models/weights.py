"""Weight containers and GGUF -> device loading.

The torch counterpart of the JAX package's ``models/weights.py``: matmul
weights are planar-decoded (``quant/planar.py``, numpy) into int8 codes and
group scales; 4-bit-class tensors whose K is a multiple of 256 are re-coded
once more to int8 per supergroup of 256 (``QLinearI8``), which is the
default on the card; with ``set_pack_int4(True)`` tensors of at most 16
distinct code values are packed two a byte instead (``QLinearI4``).
Embeddings and norms are dequantized to dense tensors.

A linear is an ``nn.Module`` holding its tensors as buffers; its forward
routes through the kernel wrappers of ``ops/qmatmul.py``, which pick the
kernel or the plain version by the tensor's device.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..gguf.reader import GGUFTensorInfo
from ..quant.dequant import dequantize
from ..quant.planar import PLANAR_FNS, planar_decode
from ..ops.qmatmul import (SUPERGROUP, pack_int4, qmatmul, qmatmul4, qmatmul_i8,
                           quantize_activations, requant_rows)


class QLinear(nn.Module):
    """Planar-quantized linear: y = x @ dequant(codes, scale, bias), f32 out."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None, group: int = 32):
        super().__init__()
        self.register_buffer("codes", codes)     # int8 (K, N)
        self.register_buffer("scale", scale)     # bf16 (K/G, N)
        self.register_buffer("bias", bias)       # bf16 (K/G, N) | None
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = qmatmul(x.reshape(-1, x.shape[-1]), self.codes, self.scale,
                    self.bias, group=self.group)
        return y.reshape(*lead, self.codes.shape[1])


class QLinearI4(nn.Module):
    """4-bit packed planar linear: two code indices a byte along K and an
    optional static 16-entry codebook, half the weight bytes of QLinear for
    4-bit-class formats."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None, group: int = 32,
                 lut16: tuple | None = None):
        super().__init__()
        self.register_buffer("packed", packed)   # uint8 (K/2, N)
        self.register_buffer("scale", scale)     # bf16 (K/G, N)
        self.register_buffer("bias", bias)       # bf16 (K/G, N) | None
        self.group = group
        self.lut16 = lut16                       # static codebook; None = idx - 8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = qmatmul4(x.reshape(-1, x.shape[-1]), self.packed, self.scale,
                     self.bias, group=self.group, lut16=self.lut16)
        return y.reshape(*lead, self.packed.shape[1])


class QLinearI8(nn.Module):
    """int8 x int8 linear: weights re-coded per (supergroup-256, column),
    activations quantized per (row, supergroup) on the fly; the per-group
    bias of asymmetric formats adds groupsum(x) @ gbias outside the int8
    product.

    ``codes`` is (K, N) at the public face; it is a view of the contiguous
    (N, K) ``codes_t`` the kernel reads (both operands K-contiguous). Only
    that one copy is held."""

    def __init__(self, codes: torch.Tensor, sw: torch.Tensor,
                 gbias: torch.Tensor | None, group: int = 32):
        super().__init__()
        self.register_buffer("codes_t", codes.t().contiguous())   # int8 (N, K)
        self.register_buffer("sw", sw)           # f32 (K/256, N)
        self.register_buffer("gbias", gbias)     # bf16 (K/G, N) | None
        self.group = group

    @property
    def codes(self) -> torch.Tensor:
        return self.codes_t.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        xq, xs = quantize_activations(x2)
        y = qmatmul_i8(xq, xs, self.codes, self.sw)
        if self.gbias is not None:
            xg = x2.float().reshape(-1, k // self.group, self.group).sum(dim=2)
            y = y + xg.to(torch.bfloat16).float() @ self.gbias.float()
        return y.reshape(*lead, self.codes_t.shape[0])


class DenseLinear(nn.Module):
    """bf16 dense linear (float GGUF tensors or non-planar formats): bf16
    operands, float32 sums — a plain product outside any kernel."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)             # bf16 (K, N)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float() @ self.w.float()


class LoraLinear(nn.Module):
    """Low-rank adapted linear: y = base(x) + scale * (x @ a) @ b, the
    runtime form of llm_build_lora_mm. The base keeps its kernel; the two
    low-rank products are plain float32 products of bf16-rounded operands,
    as the JAX package computes them outside any Pallas kernel: x @ a, its
    result rounded to bf16, then @ b. No product rounds its output to bf16.
    ``scale`` (alpha / rank times the user's scale) is a 0-d float32 tensor
    on the device, so ``runtime/lora.set_lora_scale`` writes that tensor
    alone."""

    def __init__(self, base: nn.Module, a: torch.Tensor, b: torch.Tensor,
                 scale: torch.Tensor):
        super().__init__()
        self.base = base
        self.register_buffer("a", a)             # bf16 (K, r)
        self.register_buffer("b", b)             # bf16 (r, N)
        self.register_buffer("scale", scale)     # f32 ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        xa = x.to(torch.bfloat16).float() @ self.a.float()
        delta = xa.to(torch.bfloat16).float() @ self.b.float()
        return y + delta * self.scale


def _refuse_lora(lin, what: str) -> None:
    if isinstance(lin, LoraLinear):
        raise TypeError(f"{what} of a LoraLinear: fold or fuse the base linear "
                        "before the adapter is applied")


# 4-bit weight packing at load (QLinearI4), off by default; it takes
# precedence over the int8 path for the tensors it can pack.
_PACK_INT4 = False


def set_pack_int4(flag: bool) -> None:
    """Toggle 4-bit weight packing at load."""
    global _PACK_INT4
    _PACK_INT4 = flag


# int8 x int8 path at load: None = by device (on for cuda, off for cpu, which
# lines the CPU tests up with the JAX package's CPU defaults); env IK_I8_MXU
# overrides both.
_I8_MXU: bool | None = None


def set_i8_mxu(flag: bool | None) -> None:
    """Force (or reset with None = by device) the int8 weight path at load."""
    global _I8_MXU
    _I8_MXU = flag


def i8_enabled(device: torch.device) -> bool:
    env = os.environ.get("IK_I8_MXU")
    if env is not None:
        return env not in ("0", "false", "")
    if _I8_MXU is None:
        return torch.device(device).type == "cuda"
    return _I8_MXU


def dequant_tensor(info: GGUFTensorInfo) -> np.ndarray:
    """Full float32 numpy dequantization in the tensor's logical shape."""
    out = dequantize(info.data, info.ggml_type, info.shape[0])
    return out.reshape(tuple(reversed(info.shape)))


def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def load_linear(info: GGUFTensorInfo, device, *, use_quant: bool = True):
    """GGUF weight (ne = (K, N): rows are output neurons) -> linear module.

    Planar codes arrive row-major (N, K) and are stored (K, N), contraction
    dim leading; QLinearI8 keeps them (N, K) for its kernel."""
    k = info.shape[0]
    n = info.n_elements // k
    if use_quant and info.ggml_type in PLANAR_FNS:
        pw = planar_decode(info.data, info.ggml_type, k)
        # scales/biases in bf16: the kernels round them to bf16 anyway
        bias = None if pw.bias is None else _t(pw.bias.T, device, torch.bfloat16)
        p4 = pack_int4(np.ascontiguousarray(pw.codes.T)) if _PACK_INT4 else None
        if p4 is not None:
            packed, lut = p4
            return QLinearI4(_t(packed, device), _t(pw.scale.T, device, torch.bfloat16),
                             bias, group=pw.group, lut16=lut)
        if i8_enabled(device) and k % SUPERGROUP == 0:
            codes_t, sw = requant_rows(pw.codes, pw.scale, pw.group, device)   # (N, K)
            return QLinearI8(codes_t.t(), sw.t().contiguous(), bias, group=pw.group)
        return QLinear(_t(pw.codes.T, device), _t(pw.scale.T, device, torch.bfloat16),
                       bias, group=pw.group)
    w = dequant_tensor(info).reshape(n, k).T
    return DenseLinear(_t(w, device, torch.bfloat16))


def load_dense(info: GGUFTensorInfo, device) -> torch.Tensor:
    """Norm weights and biases: float32."""
    return _t(dequant_tensor(info), device, torch.float32)


def scale_linear(lin, s: torch.Tensor):
    """Fold a scalar or per-output-channel (N,) multiplier into a linear:
    the load-time form of bitnet's post-matmul scale by its ``*.scale``
    tensors. Each scale array (or the dense weight) is multiplied in
    float32 and stored back in its own dtype, as the JAX loader does."""
    _refuse_lora(lin, "scale_linear")
    s = s.float().reshape(-1)
    mul = s[None, :] if s.numel() > 1 else s[0]

    def fold(a):
        return None if a is None else (a.float() * mul).to(a.dtype)

    if isinstance(lin, QLinearI4):
        return QLinearI4(lin.packed, fold(lin.scale), fold(lin.bias), lin.group, lin.lut16)
    if isinstance(lin, QLinearI8):
        return QLinearI8(lin.codes, fold(lin.sw), fold(lin.gbias), lin.group)
    if isinstance(lin, QLinear):
        return QLinear(lin.codes, fold(lin.scale), fold(lin.bias), lin.group)
    return DenseLinear(fold(lin.w))


def fuse_linears(linears: list):
    """Concatenate linears along the output dim into one matmul (merge-qkv /
    merge-up-gate). Returns None when they are not fusable (mixed kinds,
    mismatched K or group, bias on some only)."""
    for lin in linears:
        _refuse_lora(lin, "fuse_linears")
    first = linears[0]
    if any(type(l) is not type(first) for l in linears):
        return None
    if isinstance(first, DenseLinear):
        if any(l.w.shape[0] != first.w.shape[0] for l in linears):
            return None
        return DenseLinear(torch.cat([l.w for l in linears], dim=1))
    if isinstance(first, QLinearI4):
        k2, g, lut = first.packed.shape[0], first.group, first.lut16
        if any(l.packed.shape[0] != k2 or l.group != g or l.lut16 != lut
               for l in linears):
            return None
        has_b = [l.bias is not None for l in linears]
        if any(has_b) and not all(has_b):
            return None
        return QLinearI4(torch.cat([l.packed for l in linears], dim=1),
                         torch.cat([l.scale for l in linears], dim=1),
                         torch.cat([l.bias for l in linears], dim=1)
                         if all(has_b) else None, group=g, lut16=lut)
    k, g = first.codes.shape[0], first.group
    if any(l.codes.shape[0] != k or l.group != g for l in linears):
        return None
    if isinstance(first, QLinearI8):
        has_b = [l.gbias is not None for l in linears]
        if any(has_b) and not all(has_b):
            return None
        return QLinearI8(torch.cat([l.codes_t for l in linears], dim=0).t(),
                         torch.cat([l.sw for l in linears], dim=1),
                         torch.cat([l.gbias for l in linears], dim=1)
                         if all(has_b) else None, group=g)
    has_b = [l.bias is not None for l in linears]
    if any(has_b) and not all(has_b):
        return None
    return QLinear(torch.cat([l.codes for l in linears], dim=1),
                   torch.cat([l.scale for l in linears], dim=1),
                   torch.cat([l.bias for l in linears], dim=1)
                   if all(has_b) else None, group=g)
