"""K-shift context shifting: instead of re-prefilling when the context fills
up, the kept cache rows are moved down and the moved rows' roped dims
re-rotated by the position delta.

The torch counterpart of the JAX package's ``runtime/kshift.py``. NEOX/NORM
rope is a per-pair rotation, so it composes: rope(x, pos + d) ==
rope(rope(x, pos), d), and one extra rotation by the negative discard count
re-bases the cached keys. A quantized cache is decoded with the layer's
codec, rotated, and encoded again.

Shiftability: standard roped attention only. MLA latent caches, NoPE or
chunked-attention layers, ALiBi, recurrent models and a Hadamard-rotated K
(rope is no per-pair rotation in that basis) fall back to re-prefill.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..ops import layers as L
from ..ops.kv_quant import KV_DECODERS, KV_ENCODERS, kv_codec_of


def can_shift(cfg: ModelConfig) -> bool:
    """Roped non-MLA dense caches can be shifted."""
    return (cfg.use_rope and cfg.n_lora_kv == 0 and cfg.alibi_max_bias == 0
            and cfg.attn_chunk == 0 and not cfg.nope_layer_mask
            and not cfg.no_rope_step
            and not cfg.k_hadamard
            and not (cfg.extra or {}).get("rope_sections")
            and not (cfg.extra or {}).get("rope_dim_arr")
            and cfg.arch not in ("mamba", "qwen3next", "qwen35", "qwen35moe",
                                 "gemma4", "openpangu", "t5", "t5encoder"))


def _move(arr: torch.Tensor, n_keep: int, n_discard: int, tail: torch.Tensor) -> None:
    """arr (B, S, ...) in place: rows [0, n_keep) stay, ``tail`` (the rows
    from n_keep + n_discard on, already re-rotated where needed) follows,
    and the last n_discard rows take the first n_discard rows as filler
    (they lie past the new n_past)."""
    junk = arr[:, :n_discard].clone()
    arr[:, n_keep:n_keep + tail.shape[1]] = tail
    arr[:, arr.shape[1] - n_discard:] = junk


def k_shift(kv, cfg: ModelConfig, n_keep: int, n_discard: int, n_past: int,
            layer_offset: int = 0):
    """Discard rows [n_keep, n_keep + n_discard) of every layer; move the
    tail down and re-rotate the moved K rows' roped dims by -n_discard (the
    kept head rows stay untouched). The cache is updated in place; returns
    (kv, new n_past). Works on KVCache (bf16 or quantized) and MixedKVCache."""
    d = cfg.head_dim
    rope_dims = cfg.rope_dim or cfg.head_dim
    cut = n_keep + n_discard
    tail_len = kv.capacity - cut
    delta = torch.full((1, tail_len), -n_discard, dtype=torch.int32, device=kv.device)
    cos, sin = L.rope_cache(delta, rope_dims, cfg.rope_freq_base)
    if cfg.rope_freq_base_swa > 0 and cfg.swa_layer_mask:
        cos_swa, sin_swa = L.rope_cache(delta, rope_dims, cfg.rope_freq_base_swa)
    else:
        cos_swa, sin_swa = cos, sin

    def rotate(tail, c, s):                     # tail (B, T, Hkv, D) f32
        if rope_dims >= d:
            return L.apply_rope(tail, c, s, cfg.rope_type)
        rot = L.apply_rope(tail[..., :rope_dims], c, s, cfg.rope_type)
        return torch.cat([rot, tail[..., rope_dims:]], dim=-1)

    n_layer = kv.k.shape[0] if isinstance(kv.k, torch.Tensor) else len(kv.layer_map)
    for i in range(n_layer):
        c, s = (cos_swa, sin_swa) if cfg.layer_is_swa(i + layer_offset) else (cos, sin)
        k_slab, v_slab = kv.k[i], kv.v[i]
        if kv.quantized:
            ks_slab, vs_slab = kv.k_scale[i], kv.v_scale[i]
            codec = kv_codec_of(k_slab, d)
            tf = KV_DECODERS[codec](k_slab[:, cut:], ks_slab[:, cut:])
            tq, tqs = KV_ENCODERS[codec](rotate(tf, c, s))
            _move(k_slab, n_keep, n_discard, tq)
            _move(ks_slab, n_keep, n_discard, tqs)
            _move(vs_slab, n_keep, n_discard, vs_slab[:, cut:].clone())
        else:
            rot = rotate(k_slab[:, cut:].float(), c, s).to(k_slab.dtype)
            _move(k_slab, n_keep, n_discard, rot)
        _move(v_slab, n_keep, n_discard, v_slab[:, cut:].clone())
    return kv, n_past - n_discard
