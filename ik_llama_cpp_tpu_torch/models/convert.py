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
    {"type": "LoraLinear", "base": <a linear of the kinds above>,
     "a": (K, r), "b": (r, N), "scale": () f32}
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
supergroup codes, bf16 for planar ones). The DeepSeek-2 family's tree
(``models/deepseek2.py``) comes across the same way: its absorb arrays
wk_b / wv_b in bf16, glm-dsa's rebuilt wkv_b and the indexer's linears as
DenseLinear, the indexer's LayerNorm and the selection bias in float32; so
does the Qwen3-Next family's (``models/qwen3next.py``), whose conv kernels,
gates and norms keep float32; so does the mamba family's
(``models/mamba.py``), whose conv kernels, A, D and dt biases keep float32.
A LoRA-adapted linear (``runtime/lora.py``) carries its base linear, its
bf16 low-rank factors and its float32 scale. The BERT family's tree
(``models/bert.py``) holds its norms as (weight, bias) pairs:
``bert_from_numpy`` carries those across as pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.moe import ExpertWeights, QuantExpertWeights
from .llama import KVCache
from .mamba import MambaCache
from .qwen3next import HybridCache
from .weights import DenseLinear, LoraLinear, QLinear, QLinearI4, QLinearI8

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
    if kind == "LoraLinear":
        return LoraLinear(_linear(d["base"], device), _tensor(d["a"], device, bf16),
                          _tensor(d["b"], device, bf16),
                          _tensor(d["scale"], device, torch.float32))
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


def bert_from_numpy(params, device) -> dict:
    """The BERT family's parameter tree of the JAX package, fetched to numpy
    as for ``params_from_numpy`` with its norms left as (weight, bias | None)
    tuples, as the port's ``models/bert.load_bert_params`` gives it: the
    token embedding bf16, every other array in its own dtype (float32).
    ``device`` has no default, as for ``kv_from_numpy``."""
    def walk(tree, key: str = ""):
        if isinstance(tree, tuple):
            return tuple(_tensor(a, device) for a in tree)
        if isinstance(tree, dict) and "type" not in tree:
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return params_from_numpy(tree, device, _key=key)
    return walk(params)


def _float_tree(tree, device):
    """Every array of a tree of dicts, lists and tuples as a float32 tensor
    on ``device``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _float_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float_tree(v, device) for v in tree)
    return _tensor(tree, device, torch.float32)


def clip_from_numpy(params, device) -> dict:
    """A JAX package's encoder tree (``models/clip.load_clip_params`` or
    ``load_audio_params``), fetched to numpy, as the port's
    ``models/clip.clip_forward`` / ``whisper_forward`` take it: the same
    keys, float32 tensors, LayerNorms as (weight, bias) tuples and a
    vision projector as a list of (weight, bias | None). ``device`` has no
    default, as for ``kv_from_numpy``."""
    return _float_tree(params, device)


audio_from_numpy = clip_from_numpy      # the whisper tree converts the same way


def kv_from_numpy(k, v, k_scale=None, v_scale=None, *, device) -> KVCache:
    """A KV cache of the JAX package, fetched to numpy, as the port's: bf16
    k/v (L, B, S, Hkv, D), or codes (int8 / uint8, any of the four codecs)
    with their float32 scale stacks (L, B, S, Hkv); an MLA latent cache's
    (L, 1, 1, 1, 1) placeholder v comes across as it is (the DeepSeek-2
    forward does not read it). The arrays are copied,
    so the port's in-place row writes do not touch the caller's. ``device``
    has no default: the port's entry points run on the card unless the
    caller names the CPU."""
    if k_scale is None:
        return KVCache(_tensor(k, device, torch.bfloat16),
                       _tensor(v, device, torch.bfloat16))
    return KVCache(_tensor(k, device), _tensor(v, device),
                   _tensor(k_scale, device, torch.float32),
                   _tensor(v_scale, device, torch.float32))


def hybrid_from_numpy(k, v, conv, state, *, device) -> HybridCache:
    """A ``HybridCache`` of the JAX package (the Qwen3-Next family), fetched
    to numpy, as the port's: bf16 k/v (L, B, S, Hkv, D), float32 conv
    (L, B, d_conv - 1, conv_dim) and state (L, B, Hv, Dv, Dv). The arrays
    are copied; ``device`` has no default, as for ``kv_from_numpy``."""
    return HybridCache(_tensor(k, device, torch.bfloat16), _tensor(v, device, torch.bfloat16),
                       _tensor(conv, device, torch.float32),
                       _tensor(state, device, torch.float32))


def mamba_from_numpy(conv, ssm, *, device) -> MambaCache:
    """A ``MambaCache`` of the JAX package, fetched to numpy, as the port's:
    float32 conv tails (L, B, d_conv - 1, d_inner) and ssm states
    (L, B, d_inner, d_state). The arrays are copied; ``device`` has no
    default, as for ``kv_from_numpy``."""
    return MambaCache(_tensor(conv, device, torch.float32), _tensor(ssm, device, torch.float32))
