"""Masked plain attention over a fixed-capacity KV buffer.

The oracle for both flash-attention kernels (``ops/flash_attention.py``),
with the semantics of the JAX package's ``ops/attention.attend`` and of the
reference's llm_build_kqv: float32 softmax, optional logit softcap, GQA,
causal masking against the cache fill level, sliding window, chunked
attention and per-head sinks.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: torch.Tensor, kv_len: torch.Tensor, scale: float,
           softcap: float = 0.0, swa_window: int = 0, sinks=None,
           attn_chunk: int = 0) -> torch.Tensor:
    """q: (B, T, H, Dk); k: (B, S, Hkv, Dk); v: (B, S, Hkv, Dv).

    q_pos: (B, T) absolute query positions; kv_len: (B,) valid cache rows.
    Returns (B, T, H, Dv) in q.dtype."""
    b, t, h, d = q.shape
    s = k.shape[1]
    rep = h // k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    if rep > 1:
        kf = torch.repeat_interleave(kf, rep, dim=2)
        vf = torch.repeat_interleave(vf, rep, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    key_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, None, :]
    qp = q_pos.to(torch.int32)[:, :, None]                       # (B, T, 1)
    mask = (key_pos <= qp) & (key_pos < kv_len.to(torch.int32)[:, None, None])
    if swa_window > 0:
        mask &= key_pos > qp - swa_window
    if attn_chunk > 0:
        mask &= key_pos >= torch.div(qp, attn_chunk,
                                     rounding_mode="floor") * attn_chunk
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    if sinks is not None:
        # attention sinks (gpt-oss): an extra per-head logit in the
        # denominator
        sink = sinks.float().reshape(1, h, 1, 1)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
        e = torch.exp(scores - m)
        probs = e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, vf)
    return out.to(q.dtype)
