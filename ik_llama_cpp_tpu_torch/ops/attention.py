"""Masked plain attention over a fixed-capacity KV buffer.

The oracle for both flash-attention kernels (``ops/flash_attention.py``),
with the semantics of the JAX package's ``ops/attention.attend`` and of the
reference's llm_build_kqv: float32 softmax, optional logit softcap, GQA,
causal masking against the cache fill level, sliding window, chunked
attention, per-head sinks, ALiBi position biases and explicit per-slot key
positions (a ring cache's slots).

Besides being the oracle, it is the model's attention on three routes where
the JAX package runs XLA's ``attend`` and no Pallas kernel either: ALiBi
models and attention over a ``--swa-compress`` ring cache
(``models/llama.py``), and the DSA sparse attention of glm-dsa under its
indexer's allow mask (``models/deepseek2.py``). Those routes are plain
PyTorch on the card too.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def alibi_slopes(n_head: int, max_bias: float) -> np.ndarray:
    """Per-head ALiBi slopes as ggml_compute_forward_soft_max_f32 forms
    them: m0 = 2^(-max_bias / n_log2), m1 = 2^(-max_bias / 2 / n_log2),
    slope(h) = m0^(h+1) for h < n_log2, else m1^(2 (h - n_log2) + 1)."""
    n_log2 = 1 << int(np.floor(np.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n_log2)
    m1 = 2.0 ** (-max_bias / 2.0 / n_log2)
    return np.asarray([m0 ** (h + 1) if h < n_log2 else m1 ** (2 * (h - n_log2) + 1)
                       for h in range(n_head)], np.float32)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: torch.Tensor, kv_len: torch.Tensor, scale: float,
           softcap: float = 0.0, swa_window: int = 0, sinks=None,
           attn_chunk: int = 0, alibi=None,
           key_positions: torch.Tensor | None = None,
           allow_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, T, H, Dk); k: (B, S, Hkv, Dk); v: (B, S, Hkv, Dv).

    q_pos: (B, T) absolute query positions; kv_len: (B,) valid cache rows.
    alibi: (H,) slopes; each score gains -slope * |key pos - query pos|.
    key_positions: (B, S) the absolute position each slot holds, -1 for an
    unwritten slot (ring caches); kv_len is then not read.
    allow_mask: (B, T, S) bool, ANDed into the mask: the per-(query, key)
    top-k allow set of the DSA lightning indexer (models/deepseek2.py).
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
    qp = q_pos.to(torch.int32)[:, :, None]                       # (B, T, 1)
    if key_positions is not None:
        key_pos = key_positions.to(torch.int32)[:, None, :]      # (B, 1, S)
        mask = (key_pos <= qp) & (key_pos >= 0)
    else:
        key_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, None, :]
        mask = (key_pos <= qp) & (key_pos < kv_len.to(torch.int32)[:, None, None])
    if swa_window > 0:
        mask &= key_pos > qp - swa_window
    if attn_chunk > 0:
        mask &= key_pos >= torch.div(qp, attn_chunk,
                                     rounding_mode="floor") * attn_chunk
    if allow_mask is not None:
        mask = mask & allow_mask.to(torch.bool)
    if alibi is not None:
        dist = (key_pos - qp).abs().float()                      # (B, T, S)
        slopes = torch.as_tensor(alibi, dtype=torch.float32, device=q.device)
        scores = scores - slopes[None, :, None, None] * dist[:, None, :, :]
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
