"""MoE expert FFN for decode: the int8 supergroup two-kernel chain.

The torch counterpart of the int8 part of the JAX package's
``ops/moe_decode.py``. At decode (T <= 8 tokens) each routed (token, expert)
pair is a row of its own: its activations are quantized per (row,
supergroup-256), and

  1. ``moe_decode_gate_up_i8`` streams exactly the routed experts' gate and
     up codes, once per pair, and applies the activation: h bf16 (P, FF);
  2. ``moe_decode_down_i8`` streams their down codes and sums the top_k
     pairs of each token (the routing weight is already folded into h):
     f32 (T, E).

Expert codes are (G, K, N) int8 with f32 scales (G, K/256, N); activation
scales arrive transposed, (K/256, P), as in the JAX package. On the card the
codes must be the (G, K, N) view of a contiguous (G, N, K) tensor, which is
how ``QuantExpertWeights`` stores them (both operands K-contiguous).

Numerics: every supergroup's dot is an exact integer; its float correction
``part * (sx * sw)`` is added in supergroup order (and, for the down sum,
pair by pair), which is the order of the Pallas kernels. The plain versions
keep that order, so the kernels agree with them bit for bit up to the
activation's ``exp``.
"""
from __future__ import annotations

import torch

from . import _cuda
from .qmatmul import quantize_activations

SUPERGROUP = 256
ACTIVATIONS = {"silu": 0, "gelu": 1, "swiglu_oai": 2}


def _act(g, u, activation: str, act_limit: float):
    """act(gate) * up in float32: silu (optionally clamped), the gpt-oss
    clamped swiglu, or tanh-approximated gelu (the JAX package's ``_act``)."""
    if activation == "swiglu_oai":
        alpha, limit = 1.702, 7.0
        gc = torch.clamp(g, max=limit)
        uc = torch.clamp(u, -limit, limit)
        return gc * torch.sigmoid(alpha * gc) * (uc + 1.0)
    if activation == "silu":
        if act_limit > 0.0:
            return (torch.clamp(g * torch.sigmoid(g), max=act_limit)
                    * torch.clamp(u, -act_limit, act_limit))
        return (g * torch.sigmoid(g)) * u
    return torch.nn.functional.gelu(g, approximate="tanh") * u


def sg_accumulate(acc, q, qs, codes, sw, g: int):
    """acc + (exact int dot of supergroup g) * (qs[..., g] * sw[..., g, :]).

    q: int8 (..., R, K); qs: f32 (..., R, K/256); codes: int8 (..., K, N);
    sw: f32 (..., K/256, N), with matching leading dims. The int8 products
    of 256 terms sum below 2^24, so the float32 product is exact (TF32 off
    on the card)."""
    sl = slice(g * SUPERGROUP, (g + 1) * SUPERGROUP)
    part = torch.matmul(q[..., sl].float(), codes[..., sl, :].float())
    return acc + part * (qs[..., g:g + 1] * sw[..., g:g + 1, :])


def _pairs_i8(q, qs, codes, sw, ids):
    """Per pair p: sum over supergroups of q[p] against expert ids[p]."""
    p, k = q.shape
    ids = ids.long()
    ce, se = codes[ids], sw[ids]
    acc = torch.zeros((p, 1, codes.shape[2]), dtype=torch.float32, device=q.device)
    for g in range(k // SUPERGROUP):
        acc = sg_accumulate(acc, q[:, None], qs[:, None], ce, se, g)
    return acc[:, 0]


def moe_decode_gate_up_i8_ref(xq, xst, ids, gate_c, gate_sw, up_c, up_sw,
                              gate_b=None, up_b=None, *,
                              activation: str = "silu", act_limit: float = 0.0):
    """Plain version of kernel 7: h bf16 (P, FF)."""
    qs = xst.t()
    g = _pairs_i8(xq, qs, gate_c, gate_sw, ids)
    u = _pairs_i8(xq, qs, up_c, up_sw, ids)
    if gate_b is not None:
        g = g + gate_b[ids.long()].float()
    if up_b is not None:
        u = u + up_b[ids.long()].float()
    return _act(g, u, activation, act_limit).to(torch.bfloat16)


def moe_decode_down_i8_ref(hq, hst, ids, down_c, down_sw, *, top_k: int):
    """Plain version of kernel 8: f32 (T, E), summed pair by pair in the
    kernel's order (pair-major, supergroup-minor)."""
    pp, f = hq.shape
    t = pp // top_k
    qs = hst.t()
    ids = ids.long()
    acc = torch.zeros((t, 1, down_c.shape[2]), dtype=torch.float32, device=hq.device)
    for j in range(top_k):
        rows = torch.arange(t, device=hq.device) * top_k + j
        e = ids[rows]
        ce, se, q, s = down_c[e], down_sw[e], hq[rows][:, None], qs[rows][:, None]
        for g in range(f // SUPERGROUP):
            acc = sg_accumulate(acc, q, s, ce, se, g)
    return acc[:, 0]


def _check_codes(name, codes, sw, k, n=None):
    g, k2, n2 = codes.shape
    _cuda.require(k2 == k and (n is None or n2 == n),
                  f"{name}: codes {tuple(codes.shape)} against K={k}")
    _cuda.require(codes.dtype == torch.int8 and codes.transpose(1, 2).is_contiguous(),
                  f"{name}: codes must be the (G, K, N) view of a contiguous (G, N, K) int8 tensor")
    _cuda.require(sw.dtype == torch.float32 and sw.is_contiguous()
                  and sw.shape == (g, k // SUPERGROUP, n2),
                  f"{name}: scales must be contiguous f32 (G, K/256, N)")
    _cuda.require(_cuda.aligned16(codes) and k % SUPERGROUP == 0,
                  f"{name}: codes must be 16-byte aligned with K % 256 == 0")


def _check_act(name, q, qst, ids):
    p, k = q.shape
    _cuda.require(q.dtype == torch.int8 and q.is_contiguous() and _cuda.aligned16(q),
                  f"{name}: activations must be contiguous, 16-byte aligned int8")
    _cuda.require(qst.dtype == torch.float32 and qst.shape == (k // SUPERGROUP, p),
                  f"{name}: activation scales must be f32 (K/256, P)")
    _cuda.require(ids.dtype == torch.int32 and ids.is_contiguous() and ids.shape == (p,),
                  f"{name}: ids must be contiguous int32 (P,)")


def moe_decode_gate_up_i8(xq, xst, ids, gate_c, gate_sw, up_c, up_sw,
                          gate_b=None, up_b=None, *,
                          activation: str = "silu", act_limit: float = 0.0):
    """Routed gate/up matvecs + activation: xq int8 (P, K), xst f32
    (K/256, P), ids int32 (P,) -> h bf16 (P, FF). Optional per-expert
    biases gate_b / up_b f32 (G, FF).

    CUDA kernel ``csrc/moe_decode_i8.cu``, which replaces the Pallas kernel
    ops/moe_decode.py:moe_decode_gate_up_i8 of the JAX package. Bound by
    the routed experts' code bytes: a grid of (FF tiles, pairs), each block
    reads its own ids[p] (no scalar prefetch on the GPU) and streams its
    pair's gate and up rows with 16-byte loads into __dp4a."""
    if xq.device.type == "cpu":
        return moe_decode_gate_up_i8_ref(xq, xst, ids, gate_c, gate_sw, up_c, up_sw,
                                         gate_b, up_b, activation=activation,
                                         act_limit=act_limit)
    name = "moe_decode_gate_up_i8"
    p, k = xq.shape
    f = gate_c.shape[2]
    _check_act(name, xq, xst, ids)
    _check_codes(name, gate_c, gate_sw, k)
    _check_codes(name, up_c, up_sw, k, f)
    for b in (gate_b, up_b):
        _cuda.require(b is None or (b.dtype == torch.float32 and b.is_contiguous()
                                    and b.shape == (gate_c.shape[0], f)),
                      f"{name}: biases must be contiguous f32 (G, FF)")
    for t in (xst, ids, gate_c, gate_sw, up_c, up_sw, gate_b, up_b):
        _cuda.require(t is None or t.device == xq.device, f"{name}: operands on different devices")
    _cuda.require(activation in ACTIVATIONS, f"{name}: activation {activation!r}")
    h = torch.empty((p, f), dtype=torch.bfloat16, device=xq.device)
    fn = _cuda.function("moe_decode_i8", "ik_moe_decode_gate_up_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 8
                        + [_cuda.I] * 4 + [_cuda.F, _cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1), ids.data_ptr(),
            gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(), up_sw.data_ptr(),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), h.data_ptr(),
            p, k, f, ACTIVATIONS[activation], float(act_limit), _cuda.stream_ptr(xq))
    moe_decode_gate_up_i8.launches += 1
    _cuda.check(rc, name)
    return h


moe_decode_gate_up_i8.launches = 0      # kernel launches, counted where they happen


def moe_decode_down_i8(hq, hst, ids, down_c, down_sw, *, top_k: int):
    """Down projection summed over each token's top_k pairs: hq int8
    (P, FF) with the routing weight folded in, hst f32 (FF/256, P), ids
    int32 (P,) with P = T * top_k -> f32 (T, E).

    CUDA kernel ``csrc/moe_decode_i8.cu``, which replaces the Pallas kernel
    ops/moe_decode.py:moe_decode_down_i8 of the JAX package. Bound by the
    routed experts' down-code bytes: one block per (token, E tile) loops
    over the token's pairs and the FF supergroups in a fixed order, with no
    atomics, so the sum is deterministic."""
    if hq.device.type == "cpu":
        return moe_decode_down_i8_ref(hq, hst, ids, down_c, down_sw, top_k=top_k)
    name = "moe_decode_down_i8"
    pp, f = hq.shape
    _cuda.require(pp % top_k == 0, f"{name}: {pp} pairs for top_k {top_k}")
    _check_act(name, hq, hst, ids)
    _check_codes(name, down_c, down_sw, f)
    for t in (hst, ids, down_c, down_sw):
        _cuda.require(t.device == hq.device, f"{name}: operands on different devices")
    e = down_c.shape[2]
    out = torch.empty((pp // top_k, e), dtype=torch.float32, device=hq.device)
    fn = _cuda.function("moe_decode_i8", "ik_moe_decode_down_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 4
                        + [_cuda.I] * 4 + [_cuda.P])
    rc = fn(hq.data_ptr(), hst.data_ptr(), hst.stride(0), hst.stride(1), ids.data_ptr(),
            down_c.data_ptr(), down_sw.data_ptr(), out.data_ptr(),
            pp // top_k, top_k, f, e, _cuda.stream_ptr(hq))
    moe_decode_down_i8.launches += 1
    _cuda.check(rc, name)
    return out


moe_decode_down_i8.launches = 0


def moe_decode_i8(x, w, idx, experts, *, activation: str = "silu",
                  act_limit: float = 0.0, plain: bool = False):
    """The decode FFN over supergroup experts: x (T, E), routing weights w
    (T, k) and expert ids idx (T, k) -> f32 (T, E). Quantize the repeated
    rows, kernel 7, fold the routing weight into bf16 h, quantize, kernel
    8, then the optional per-expert down bias. ``plain`` runs the plain
    versions of both kernels on any device."""
    gate_up = moe_decode_gate_up_i8_ref if plain else moe_decode_gate_up_i8
    down = moe_decode_down_i8_ref if plain else moe_decode_down_i8
    t, k = idx.shape
    ids = idx.reshape(-1).to(torch.int32)
    xp = x.to(torch.bfloat16).repeat_interleave(k, dim=0)
    xq, xs = quantize_activations(xp)
    h = gate_up(xq, xs.t(), ids, experts.gate, experts.gate_s, experts.up,
                experts.up_s, experts.gate_b, experts.up_b,
                activation=activation, act_limit=act_limit)
    h = (h.float() * w.reshape(-1)[:, None]).to(torch.bfloat16)
    hq, hs = quantize_activations(h)
    out = down(hq, hs.t(), ids, experts.down, experts.down_s, top_k=k)
    if experts.down_b is not None:
        db = experts.down_b[ids.long()].reshape(t, k, -1).float()
        out = out + torch.sum(db * w[:, :, None], dim=1)
    return out


def moe_decode_i8_ref(x, w, idx, experts, *, activation: str = "silu",
                      act_limit: float = 0.0):
    """Plain version of the whole decode FFN (the JAX package's
    ``moe_decode_i8_ref``): the same quantization points and exact integer
    dots as the kernel chain."""
    return moe_decode_i8(x, w, idx, experts, activation=activation,
                         act_limit=act_limit, plain=True)
