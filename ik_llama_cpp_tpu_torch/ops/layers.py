"""Elementwise / normalization / rotary ops in plain torch.

Numerics mirror the JAX package's ``ops/layers.py`` (and through it the
reference graph builders): every reduction and rotation runs in float32 and
the result is cast back to the input dtype.
  * RMS norm: y = x * rsqrt(mean(x^2) + eps) * w
  * RoPE NORM mode rotates consecutive pairs, NEOX mode rotates halves
  * gated FFN: act(gate) * up
"""
from __future__ import annotations

import math

import numpy as np
import torch

ROPE_TYPE_NORM = 0   # consecutive pairs (original llama GGUF convention)
ROPE_TYPE_NEOX = 2   # rotate halves


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is None:
        return y.to(dt)
    return (y * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def rope_cache(positions: torch.Tensor, head_dim: int,
               freq_base: float = 10000.0, freq_scale: float = 1.0, *,
               ext_factor: float = 0.0, attn_factor: float = 1.0,
               beta_fast: float = 32.0, beta_slow: float = 1.0,
               n_ctx_orig: int = 0):
    """cos/sin tables: positions (...,) -> two float32 (..., head_dim // 2).

    Implements ggml's rope_yarn correction (rope_yarn / rope_yarn_ramp);
    with ext_factor == 0 it reduces to plain (linearly scaled) rope."""
    half = head_dim // 2
    dims = torch.arange(half, dtype=torch.float32, device=positions.device)
    theta_extrap = positions.float()[..., None] / (freq_base ** (dims / half))
    mscale = attn_factor
    if ext_factor != 0.0 and n_ctx_orig > 0:
        def corr_dim(n_rot_beta):
            return half * 2 * math.log(n_ctx_orig / (n_rot_beta * 2 * math.pi)) / (
                2 * math.log(freq_base))
        low = max(0.0, math.floor(corr_dim(beta_fast)))
        high = min(head_dim - 1.0, math.ceil(corr_dim(beta_slow)))
        i0 = 2.0 * dims
        ramp = 1.0 - torch.clamp((i0 / 2.0 - low) / max(0.001, high - low),
                                 0.0, 1.0)
        ramp_mix = ramp * ext_factor
        theta_interp = freq_scale * theta_extrap
        theta = theta_interp * (1 - ramp_mix) + theta_extrap * ramp_mix
        mscale = attn_factor * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    else:
        theta = freq_scale * theta_extrap
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_type: int = ROPE_TYPE_NEOX) -> torch.Tensor:
    """x: (..., T, H, D); cos/sin: (..., T, R//2) broadcast over heads.

    When R < D only the first R dims rotate (partial rotary)."""
    d = x.shape[-1]
    rot = cos.shape[-1] * 2
    if rot < d:
        return torch.cat([apply_rope(x[..., :rot], cos, sin, rope_type),
                          x[..., rot:]], dim=-1)
    half = d // 2
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    if rope_type == ROPE_TYPE_NEOX:
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:  # NORM: consecutive pairs (x0,x1), (x2,x3), ...
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def imrope_text_mask(sections, n_rot: int) -> np.ndarray:
    """Per-dim-pair rotation mask of interleaved mrope (qwen3vl) for text
    tokens: each pair (sector = pair % sum(sections)) goes round-robin to
    the t/h/w streams, and unmatched sectors to the "extra" stream, whose
    text position is 0 (ggml_mrope_cache_init; llama.cpp feeds text
    positions [t, t, t, 0]). Returns a bool (n_rot // 2,) mask: True =
    rotate by the token position, False = no rotation."""
    s = list(sections) + [0] * (4 - len(sections))
    sect_dims = s[0] + s[1] + s[2] + s[3]
    mask = np.zeros(n_rot // 2, dtype=bool)
    for j in range(n_rot // 2):
        sector = j % max(sect_dims, 1)
        mask[j] = ((sector % 3 == 1 and sector < 3 * s[1])
                   or (sector % 3 == 2 and sector < 3 * s[2])
                   or (sector % 3 == 0 and sector < 3 * s[0]))
    return mask


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def glu(gate: torch.Tensor, up: torch.Tensor, act: str = "silu",
        limit: float = 0.0) -> torch.Tensor:
    """Gated FFN activation act(gate) * up (llm_build_ffn's SILU / GELU /
    RELU_SQR / SWIGLU_OAI variants). ``limit`` > 0 clamps as the
    swiglu_limits models do: min(silu(g), limit) * clamp(u, -limit, limit)."""
    gf = gate.float()
    if limit > 0.0 and act == "silu":
        g = torch.clamp(silu(gf), max=limit)
        return (g * torch.clamp(up.float(), -limit, limit)).to(up.dtype)
    if act == "gelu":
        a = gelu(gf)
    elif act == "relu2":
        a = torch.square(torch.relu(gf))
    elif act == "swiglu_oai":
        g = torch.clamp(gf, max=7.0)
        u = torch.clamp(up.float(), -7.0, 7.0)
        return (g * torch.sigmoid(1.702 * g) * (u + 1.0)).to(gate.dtype)
    else:
        a = gf * torch.sigmoid(gf)
    return a.to(gate.dtype) * up


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """ggml SOFTCAP: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
