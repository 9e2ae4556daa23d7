"""Flash attention over a fixed-capacity KV cache: prefill and decode.

Two wrappers with one contract (the JAX package's ``flash_attention`` and
``flash_attention_decode``): q (B, T, H, Dk) attends causally from absolute
positions q_pos0 .. q_pos0 + T - 1 to the cache rows < kv_len of k/v
(B, S, Hkv, D*), with GQA, logit softcap, sliding window, llama4 attention
chunks and per-head sinks; the result is (B, T, H, Dv) in q's dtype.

A CPU tensor takes the plain version (``ops/attention.attend``); a CUDA
tensor launches the kernel (``csrc/flash_attention.cu`` for prefill,
``csrc/flash_attention_decode.cu`` for T <= 16) or raises.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import attend

DECODE_MAX_T = 16


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


def _launch(symbol, lib, q, k, v, q_pos0, kv_len, scale, softcap, swa_window,
            attn_chunk, sinks):
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
    fn = _cuda.function(lib, symbol, [_cuda.P] * 7 + [_cuda.I] * 6
                        + [_cuda.L] * 9 + [_cuda.F] * 2 + [_cuda.I] * 2
                        + [_cuda.P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kl.data_ptr(), None if sk is None else sk.data_ptr(),
            out.data_ptr(), b, t, h, hkv, dk, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), float(softcap), int(swa_window), int(attn_chunk),
            _cuda.stream_ptr(q))
    return rc, out


def flash_attention(q, k, v, q_pos0, kv_len, *, scale: float,
                    softcap: float = 0.0, swa_window: int = 0,
                    attn_chunk: int = 0, sinks=None):
    """Prefill attention (any T). CUDA kernel ``csrc/flash_attention.cu``,
    which replaces the Pallas kernel flash_attention.py:flash_attention of
    the JAX package. It is bound by bf16 tensor-core work on the live part
    of the causal score matrix; each block loops only over its live key
    range, which is what the TPU kernel's tile clamp achieved by skipping
    DMAs."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos0, kv_len, scale=scale,
                             softcap=softcap, swa_window=swa_window,
                             attn_chunk=attn_chunk, sinks=sinks)
    rc, out = _launch("ik_flash_attention", "flash_attention", q, k, v,
                      q_pos0, kv_len, scale, softcap, swa_window, attn_chunk,
                      sinks)
    flash_attention.launches += 1
    _cuda.check(rc, "flash_attention")
    return out


flash_attention.launches = 0      # kernel launches, counted where they happen


def flash_attention_decode(q, k, v, q_pos0, kv_len, *, scale: float,
                           softcap: float = 0.0, swa_window: int = 0,
                           attn_chunk: int = 0, sinks=None):
    """Decode / short-chunk attention (T <= 16) over a (B, S, Hkv, D) layer
    slab, which may be a view of the model's stacked cache. CUDA kernel
    ``csrc/flash_attention_decode.cu``, which replaces the Pallas kernel
    flash_attention.py:flash_attention_decode (quant none) of the JAX
    package. It is bound by the filled K/V bytes; the q rows of a GQA group
    share each K/V tile, so the cache is read once per kv head. Unlike the
    TPU kernel it takes any S and any head dim up to 256 that is a multiple
    of 8, and raises on anything else instead of returning None."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos0, kv_len, scale=scale,
                             softcap=softcap, swa_window=swa_window,
                             attn_chunk=attn_chunk, sinks=sinks)
    _cuda.require(q.shape[1] <= DECODE_MAX_T,
                  f"flash_attention_decode: T={q.shape[1]} > {DECODE_MAX_T}")
    rc, out = _launch("ik_flash_attention_decode", "flash_attention_decode",
                      q, k, v, q_pos0, kv_len, scale, softcap, swa_window,
                      attn_chunk, sinks)
    flash_attention_decode.launches += 1
    _cuda.check(rc, "flash_attention_decode")
    return out


flash_attention_decode.launches = 0
