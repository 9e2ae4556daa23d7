"""Gated delta-net recurrence (Qwen3-Next linear attention) in plain PyTorch.

The torch counterpart of the JAX package's ``ops/delta_net.py`` (the
analogue of GGML_OP_DELTA_NET). Per head with state S (Dv, Dk), per token:
    qn = q/||q||, kn = k/||k||, scale = 1/sqrt(D)
    beta = sigmoid(beta_raw); decay = exp(min(g, 50))
    attn  = kn . (qn * scale)
    v'    = S @ k            (raw k)
    out0  = S @ q            (raw q)
    v_new = beta * v - beta * decay * v' / ||k||
    out   = out0 * decay * scale / ||q|| + v_new * attn
    S     = clip(decay * S + v_new kn^T, +-1e6)

The JAX package runs this as a ``lax.scan`` that XLA compiles (no Pallas
kernel), so the port keeps it plain: a Python loop over tokens on the
state's device. The per-token scalars (norms, sigmoid, decay, attn) are
computed for the whole chunk up front; each step then runs the (B, H, D, D)
products and the state update, seven launches on the card. A hand-written
recurrence kernel is a queued follow-up.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12
CLIP = 1e6


def delta_net(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, state: torch.Tensor, *, repeat_type: int = 0):
    """q, k: (B, T, Hkq, D); v: (B, T, H, D); g, beta: (B, T, H);
    state: (B, H, Dv=D, Dk=D). Returns (out float32 (B, T, H, D), new
    float32 state); ``state`` itself is not written.

    GQA: H % Hkq == 0; repeat_type 0 maps v-head h to kq-head h // ratio,
    type 1 to h % Hkq."""
    b, t, hkq, d = q.shape
    h = v.shape[2]
    ratio = h // hkq
    if ratio > 1:
        if repeat_type == 0:
            q = q.repeat_interleave(ratio, dim=2)
            k = k.repeat_interleave(ratio, dim=2)
        else:
            q = q.repeat(1, 1, ratio, 1)
            k = k.repeat(1, 1, ratio, 1)
    q, k, v = q.float(), k.float(), v.float()
    scale = float(1.0 / np.sqrt(d))
    # the per-token scalars, (B, T, H)
    qn_inv = torch.rsqrt(torch.sum(q * q, -1) + EPS)
    kn_inv = torch.rsqrt(torch.sum(k * k, -1) + EPS)
    beta_v = torch.sigmoid(beta.float())
    decay = torch.exp(torch.clamp(g.float(), max=50.0))
    attn = torch.sum(k * q, -1) * kn_inv * qn_inv * scale
    # each per-token operand as a view of its own, shaped for its product,
    # so that a step indexes nothing
    bv = (beta_v[..., None] * v).unbind(1)                   # beta * v
    c_vp = (beta_v * decay * kn_inv)[..., None].unbind(1)    # the v' factor
    c_o0 = ((decay * qn_inv)[..., None] * scale).unbind(1)   # the out0 factor
    dec = decay[..., None, None].unbind(1)
    kn = (k * kn_inv[..., None])[..., None, :].unbind(1)
    at = attn[..., None].unbind(1)
    qk = torch.stack([k, q], dim=-1).unbind(1)               # (B, H, D, 2) a token
    s = state.float().clone()
    outs = torch.empty((b, t, h, d), dtype=torch.float32, device=s.device)
    for i, out in enumerate(outs.unbind(1)):
        vp, o0 = torch.matmul(s, qk[i]).unbind(-1)           # S @ k, S @ q
        v_new = torch.addcmul(bv[i], c_vp[i], vp, value=-1.0)
        torch.addcmul(o0 * c_o0[i], v_new, at[i], out=out)
        s.mul_(dec[i])
        s.addcmul_(v_new[..., None], kn[i])
        s.clamp_(-CLIP, CLIP)
    return outs, s
