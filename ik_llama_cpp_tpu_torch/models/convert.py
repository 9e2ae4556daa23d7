"""Carry parameters over from numpy into the port's layout.

``params_from_numpy`` takes a parameter tree of nested dicts and lists whose
arrays are numpy and whose linears are dicts tagged with their kind:

    {"type": "QLinearI8", "codes": (K, N) int8, "sw": (K/256, N) f32,
     "gbias": (K/G, N) | None, "group": G}
    {"type": "QLinear", "codes": (K, N) int8, "scale": (K/G, N),
     "bias": (K/G, N) | None, "group": G}
    {"type": "QLinearI4", "packed": (K/2, N) uint8, "scale": (K/G, N),
     "bias": (K/G, N) | None, "group": G, "lut16": 16 floats | None}
    {"type": "DenseLinear", "w": (K, N)}
    {"type": "QuantExpertWeights", "gate" | "up" | "down": (G, K, N) int8,
     "gate_s" | "up_s" | "down_s": (G, K/group, N) f32 or bf16,
     "gate_group" | "up_group" | "down_group": int,
     "gate_b" | "up_b" | "down_b": (G, N) | None}
    {"type": "ExpertWeights", "gate" | "up" | "down": (G, K, N) bf16,
     "gate_b" | "up_b" | "down_b": (G, N) | None}

which is the JAX package's parameter pytree with each array fetched to
numpy, and returns the port's tree: the same nesting, torch tensors on
``device`` and linear modules, computing what the JAX model computes.
Scales, group biases, dense weights and the token embedding are stored in
bf16 as the JAX loaders store them; other float arrays keep float32. Expert
codes are stored (G, N, K) and held as their (G, K, N) view, as the port's
loader holds them; expert scales keep the dtype they come in (f32 for
supergroup codes, bf16 for planar ones).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.moe import ExpertWeights, QuantExpertWeights
from .llama import KVCache
from .weights import DenseLinear, QLinear, QLinearI4, QLinearI8

_BF16_KEYS = ("tok_embd",)


def _tensor(a, device, dtype=None) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: exact via f32
        a, dtype = a.astype(np.float32), dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a, order="C"))    # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _linear(d: dict, device):
    kind = d["type"]
    bf16 = torch.bfloat16
    if kind == "QLinearI8":
        codes_t = _tensor(np.asarray(d["codes"]).T, device, torch.int8)
        return QLinearI8(codes_t.t(), _tensor(d["sw"], device, torch.float32),
                         _tensor(d.get("gbias"), device, bf16),
                         group=int(d["group"]))
    if kind == "QLinear":
        return QLinear(_tensor(d["codes"], device, torch.int8),
                       _tensor(d["scale"], device, bf16),
                       _tensor(d.get("bias"), device, bf16),
                       group=int(d["group"]))
    if kind == "QLinearI4":
        lut = d.get("lut16")
        return QLinearI4(_tensor(d["packed"], device, torch.uint8),
                         _tensor(d["scale"], device, bf16),
                         _tensor(d.get("bias"), device, bf16),
                         group=int(d["group"]),
                         lut16=None if lut is None else tuple(float(v) for v in lut))
    if kind == "DenseLinear":
        return DenseLinear(_tensor(d["w"], device, bf16))
    if kind == "QuantExpertWeights":
        kw = {}
        for p in ("gate", "up", "down"):
            codes_t = _tensor(np.asarray(d[p]).transpose(0, 2, 1), device, torch.int8)
            kw[p] = codes_t.transpose(1, 2)
            kw[p + "_s"] = _tensor(d[p + "_s"], device)
            kw[p + "_group"] = int(d[p + "_group"])
            kw[p + "_b"] = _tensor(d.get(p + "_b"), device, torch.float32)
        return QuantExpertWeights(**kw)
    if kind == "ExpertWeights":
        kw = {}
        for p in ("gate", "up", "down"):
            kw[p] = _tensor(d[p], device, bf16)
            kw[p + "_b"] = _tensor(d.get(p + "_b"), device, torch.float32)
        return ExpertWeights(**kw)
    raise NotImplementedError(f"params_from_numpy: linear kind {kind!r} is "
                              "not ported yet")


def params_from_numpy(tree, device, *, _key: str = ""):
    if isinstance(tree, dict):
        if "type" in tree:
            return _linear(tree, device)
        return {k: params_from_numpy(v, device, _key=k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, _key=_key) for v in tree]
    return _tensor(tree, device, torch.bfloat16 if _key in _BF16_KEYS else None)


def kv_from_numpy(k, v, k_scale=None, v_scale=None, device="cpu") -> KVCache:
    """A KV cache of the JAX package, fetched to numpy, as the port's: bf16
    k/v (L, B, S, Hkv, D), or codes (int8 / uint8, any of the four codecs)
    with their float32 scale stacks (L, B, S, Hkv). The arrays are copied,
    so the port's in-place row writes do not touch the caller's."""
    if k_scale is None:
        return KVCache(_tensor(k, device, torch.bfloat16),
                       _tensor(v, device, torch.bfloat16))
    return KVCache(_tensor(k, device), _tensor(v, device),
                   _tensor(k_scale, device, torch.float32),
                   _tensor(v_scale, device, torch.float32))
