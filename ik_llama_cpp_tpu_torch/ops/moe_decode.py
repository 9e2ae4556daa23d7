"""MoE expert FFN for decode: the int8 supergroup chain, its single-kernel
form, and the planar (bf16-dequant) chain.

The torch counterpart of the JAX package's ``ops/moe_decode.py``. At decode
(T <= 8 tokens) each routed (token, expert) pair is a row of its own.

int8 chain (experts re-coded per supergroup of 256; activations quantized
per (row, supergroup)):

  1. ``moe_decode_gate_up_i8`` streams exactly the routed experts' gate and
     up codes, once per pair, and applies the activation: h bf16 (P, FF);
  2. ``moe_decode_down_i8`` streams their down codes and sums the top_k
     pairs of each token (the routing weight is already folded into h):
     f32 (T, E);

or both in one launch, ``moe_decode_fused_i8``, which also folds the routing
weight and requantizes h inside the kernel (``IK_MOE_FUSED_TG=1``).

Planar chain (any group per projection, e.g. a down projection whose K is
no multiple of 256 and keeps its group-32 bf16 scales): ``moe_decode_gate_up``
and ``moe_decode_down`` over bf16 rows, the weight dequantized in bf16.

Expert codes are (G, K, N) int8 with scales (G, K/group, N) (f32 for the
int8 chain; f32 or bf16 for the planar one); activation scales arrive
transposed, (K/256, P), as in the JAX package. On the card the codes must
be the (G, K, N) view of a contiguous (G, N, K) tensor, which is how
``QuantExpertWeights`` stores them (both operands K-contiguous).

Numerics. int8: every supergroup's dot is an exact integer; its float
correction ``part * (sx * sw)`` is added in supergroup order (and, for the
down sum, pair by pair), which is the order of the Pallas kernels. The
plain versions keep that order, so the kernels agree with them bit for bit
up to the activation's ``exp``. Planar: w = bf16(bf16(code) * bf16(scale)),
bf16 x bf16 products summed in float32; only the order of that sum differs
between a kernel and its plain version.
"""
from __future__ import annotations

import torch

from . import _cuda
from .qmatmul import quantize_activations, true_div

SUPERGROUP = 256
SMEM_LIMIT = 232448           # bytes of shared memory a block may use on sm_90
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


def requant_by_inverse(h):
    """h (..., FF) -> (int8 codes (..., FF), f32 scales (..., FF/256)) per
    (row, supergroup) by multiplying by 1 / scale, which is what the kernels
    that requantize h themselves do (``quantize_activations`` divides)."""
    lead, f = h.shape[:-1], h.shape[-1]
    hg = h.float().reshape(*lead, f // SUPERGROUP, SUPERGROUP)
    sc = true_div(torch.amax(torch.abs(hg), dim=-1, keepdim=True), 127.0)
    inv = torch.where(sc > 0, 1.0 / torch.where(sc > 0, sc, torch.ones_like(sc)),
                      torch.zeros_like(sc))
    q = torch.clamp(torch.round(hg * inv), -127, 127)
    return q.to(torch.int8).reshape(*lead, f), sc[..., 0]


def moe_decode_fused_i8_ref(xq, xst, ids, wts, gate_c, gate_sw, up_c, up_sw, down_c,
                            down_sw, gate_b=None, up_b=None, *, top_k: int,
                            activation: str = "silu", act_limit: float = 0.0):
    """Plain version of kernel 11: kernel 7's function, the routing weight
    folded into bf16 h, h requantized by 1 / scale, kernel 8's function."""
    h = moe_decode_gate_up_i8_ref(xq, xst, ids, gate_c, gate_sw, up_c, up_sw, gate_b, up_b,
                                  activation=activation, act_limit=act_limit)
    h = (h.float() * wts[:, None]).to(torch.bfloat16)
    hq, hs = requant_by_inverse(h)
    return moe_decode_down_i8_ref(hq, hs.t(), ids, down_c, down_sw, top_k=top_k)


def fused_decode_smem_bytes(k: int, ff: int, top_k: int) -> int:
    """Shared memory of a block of csrc/moe_decode_fused_i8.cu: the larger
    of the pair's int8 row and the token's requantized rows, each with its
    supergroup scales."""
    return max(k + k // SUPERGROUP * 4, top_k * (ff + ff // SUPERGROUP * 4))


def fused_decode_fits(k: int, ff: int, top_k: int) -> bool:
    """Whether kernel 11 takes these shapes, decided from shapes alone (the
    counterpart of the JAX kernel returning None): supergroup K and FF and
    a token's rows in one block's shared memory. Models that fail it take
    the two-kernel chain."""
    return (k % SUPERGROUP == 0 and ff % SUPERGROUP == 0
            and fused_decode_smem_bytes(k, ff, top_k) <= SMEM_LIMIT)


def moe_decode_fused_i8(xq, xst, ids, wts, gate_c, gate_sw, up_c, up_sw, down_c, down_sw,
                        gate_b=None, up_b=None, *, top_k: int,
                        activation: str = "silu", act_limit: float = 0.0):
    """The routed FFN of a decode step in one launch: xq int8 (P, K), xst
    f32 (K/256, P), ids int32 (P,), wts f32 (P,) routing weight per pair
    (ones when it was folded into x), P = T * top_k -> f32 (T, E).
    ``fused_decode_fits`` must hold.

    CUDA kernel ``csrc/moe_decode_fused_i8.cu``, which replaces the Pallas
    kernel ops/moe_decode.py:moe_decode_fused_i8 of the JAX package. Bound
    by the routed experts' code bytes: a cooperative launch whose first
    phase is kernel 7's grid writing bf16 h (weight folded in) to a scratch
    of P x FF, and whose second phase, after a grid-wide barrier,
    requantizes each token's rows in shared memory and runs kernel 8's
    sum in pair order; no float atomics."""
    if xq.device.type == "cpu":
        return moe_decode_fused_i8_ref(xq, xst, ids, wts, gate_c, gate_sw, up_c, up_sw,
                                       down_c, down_sw, gate_b, up_b, top_k=top_k,
                                       activation=activation, act_limit=act_limit)
    name = "moe_decode_fused_i8"
    p, k = xq.shape
    f, e = gate_c.shape[2], down_c.shape[2]
    _cuda.require(p % top_k == 0 and fused_decode_fits(k, f, top_k),
                  f"{name}: shapes P={p} top_k={top_k} K={k} FF={f} do not fit the kernel")
    _check_act(name, xq, xst, ids)
    _check_codes(name, gate_c, gate_sw, k)
    _check_codes(name, up_c, up_sw, k, f)
    _check_codes(name, down_c, down_sw, f)
    _cuda.require(wts.dtype == torch.float32 and wts.is_contiguous() and wts.shape == (p,),
                  f"{name}: wts must be contiguous f32 (P,)")
    for b in (gate_b, up_b):
        _cuda.require(b is None or (b.dtype == torch.float32 and b.is_contiguous()
                                    and b.shape == (gate_c.shape[0], f)),
                      f"{name}: biases must be contiguous f32 (G, FF)")
    for t in (xst, ids, wts, gate_c, gate_sw, up_c, up_sw, down_c, down_sw, gate_b, up_b):
        _cuda.require(t is None or t.device == xq.device, f"{name}: operands on different devices")
    _cuda.require(activation in ACTIVATIONS, f"{name}: activation {activation!r}")
    hbuf = torch.empty((p, f), dtype=torch.bfloat16, device=xq.device)
    out = torch.empty((p // top_k, e), dtype=torch.float32, device=xq.device)
    fn = _cuda.function("moe_decode_fused_i8", "ik_moe_decode_fused_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 12
                        + [_cuda.I] * 6 + [_cuda.F, _cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1), ids.data_ptr(),
            wts.data_ptr(), gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(),
            up_sw.data_ptr(), down_c.data_ptr(), down_sw.data_ptr(),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
            p, top_k, k, f, e, ACTIVATIONS[activation], float(act_limit),
            _cuda.stream_ptr(xq))
    moe_decode_fused_i8.launches += 1
    _cuda.check(rc, name)
    return out


moe_decode_fused_i8.launches = 0


def _down_bias(out, experts, ids, w, weight_before_ffn: bool):
    """out + the routed experts' down biases, weighted like their outputs."""
    if experts.down_b is None:
        return out
    t, k = w.shape
    db = experts.down_b[ids.long()].reshape(t, k, -1).float()
    return out + torch.sum(db if weight_before_ffn else db * w[:, :, None], dim=1)


def moe_decode_i8(x, w, idx, experts, *, activation: str = "silu",
                  act_limit: float = 0.0, weight_before_ffn: bool = False,
                  fused: bool = False, plain: bool = False):
    """The decode FFN over supergroup experts: x (T, E), routing weights w
    (T, k) and expert ids idx (T, k) -> f32 (T, E). Quantize the repeated
    rows (scaled by their routing weight first under ``weight_before_ffn``),
    kernel 7, fold the routing weight into bf16 h, quantize, kernel 8; or,
    with ``fused``, kernel 11 for all of that; then the optional per-expert
    down bias. ``plain`` runs the plain versions on any device."""
    t, k = idx.shape
    ids = idx.reshape(-1).to(torch.int32)
    xp = x.to(torch.bfloat16).repeat_interleave(k, dim=0)
    if weight_before_ffn:
        xp = xp * w.reshape(-1)[:, None].to(torch.bfloat16)
    xq, xs = quantize_activations(xp)
    if fused:
        fn = moe_decode_fused_i8_ref if plain else moe_decode_fused_i8
        wvec = (torch.ones_like(w.reshape(-1), dtype=torch.float32) if weight_before_ffn
                else w.reshape(-1).float().contiguous())
        out = fn(xq, xs.t(), ids, wvec, experts.gate, experts.gate_s, experts.up,
                 experts.up_s, experts.down, experts.down_s, experts.gate_b, experts.up_b,
                 top_k=k, activation=activation, act_limit=act_limit)
        return _down_bias(out, experts, ids, w, weight_before_ffn)
    gate_up = moe_decode_gate_up_i8_ref if plain else moe_decode_gate_up_i8
    down = moe_decode_down_i8_ref if plain else moe_decode_down_i8
    h = gate_up(xq, xs.t(), ids, experts.gate, experts.gate_s, experts.up,
                experts.up_s, experts.gate_b, experts.up_b,
                activation=activation, act_limit=act_limit)
    if not weight_before_ffn:
        h = (h.float() * w.reshape(-1)[:, None]).to(torch.bfloat16)
    hq, hs = quantize_activations(h)
    out = down(hq, hs.t(), ids, experts.down, experts.down_s, top_k=k)
    return _down_bias(out, experts, ids, w, weight_before_ffn)


def moe_decode_i8_ref(x, w, idx, experts, *, activation: str = "silu",
                      act_limit: float = 0.0, weight_before_ffn: bool = False):
    """Plain version of the whole int8 decode FFN (the JAX package's
    ``moe_decode_i8_ref``): the same quantization points and exact integer
    dots as the kernel chain."""
    return moe_decode_i8(x, w, idx, experts, activation=activation, act_limit=act_limit,
                         weight_before_ffn=weight_before_ffn, plain=True)


# --------------------------------------------------------------------------
# planar chain: bf16 rows against int8 codes with group scales
# --------------------------------------------------------------------------

def dequant_experts(codes, scale, group: int):
    """bf16(codes) * bf16(scale) per group, rounded to bf16: codes
    (..., K, N) int8, scale (..., K/group, N) f32 or bf16 -> bf16 (..., K, N).
    The dequant chain of the Pallas kernels and of the JAX oracles."""
    return codes.to(torch.bfloat16) * torch.repeat_interleave(
        scale.to(torch.bfloat16), group, dim=-2)


def _pairs_planar(xp, codes, scale, ids, group: int):
    """Per pair p: xp[p] (bf16, float32 sums) against the dequantized
    expert ids[p]: f32 (P, N)."""
    ids = ids.long()
    w = dequant_experts(codes[ids], scale[ids], group)
    return torch.bmm(xp.to(torch.bfloat16).float()[:, None], w.float())[:, 0]


def moe_decode_gate_up_ref(xp, ids, gate_c, gate_s, up_c, up_s, gate_b=None, up_b=None, *,
                           group: int = 32, activation: str = "silu",
                           act_limit: float = 0.0):
    """Plain version of kernel 12: h bf16 (P, FF)."""
    g = _pairs_planar(xp, gate_c, gate_s, ids, group)
    u = _pairs_planar(xp, up_c, up_s, ids, group)
    if gate_b is not None:
        g = g + gate_b[ids.long()].float()
    if up_b is not None:
        u = u + up_b[ids.long()].float()
    return _act(g, u, activation, act_limit).to(torch.bfloat16)


def moe_decode_down_ref(hw, ids, down_c, down_s, *, top_k: int, group: int = 32):
    """Plain version of kernel 13: f32 (T, E), each token's pairs added in
    pair order."""
    y = _pairs_planar(hw, down_c, down_s, ids, group)
    y = y.reshape(-1, top_k, y.shape[-1])
    out = torch.zeros_like(y[:, 0])
    for j in range(top_k):
        out = out + y[:, j]
    return out


def _check_planar(name, codes, scale, k, group, n=None):
    g, k2, n2 = codes.shape
    _cuda.require(k2 == k and (n is None or n2 == n),
                  f"{name}: codes {tuple(codes.shape)} against K={k}")
    _cuda.require(codes.dtype == torch.int8 and codes.transpose(1, 2).is_contiguous()
                  and _cuda.aligned16(codes),
                  f"{name}: codes must be the (G, K, N) view of a contiguous, 16-byte "
                  "aligned (G, N, K) int8 tensor")
    _cuda.require(k % 16 == 0 and group % 16 == 0 and k % group == 0,
                  f"{name}: K={k} and group={group} must be multiples of 16, K of group")
    _cuda.require(scale.dtype in (torch.float32, torch.bfloat16) and scale.is_contiguous()
                  and scale.shape == (g, k // group, n2),
                  f"{name}: scales must be contiguous f32 or bf16 (G, K/group, N)")


def _check_rows(name, xp, ids):
    _cuda.require(xp.dtype == torch.bfloat16 and xp.is_contiguous() and _cuda.aligned16(xp),
                  f"{name}: rows must be contiguous, 16-byte aligned bf16")
    _cuda.require(ids.dtype == torch.int32 and ids.is_contiguous()
                  and ids.shape == (xp.shape[0],),
                  f"{name}: ids must be contiguous int32 (P,)")


def moe_decode_gate_up(xp, ids, gate_c, gate_s, up_c, up_s, gate_b=None, up_b=None, *,
                       group: int = 32, activation: str = "silu", act_limit: float = 0.0):
    """Routed planar gate/up matvecs + activation: xp bf16 (P, K), ids int32
    (P,), codes int8 (G, K, FF), scales f32 or bf16 (G, K/group, FF) ->
    h bf16 (P, FF). Optional per-expert biases gate_b / up_b f32 (G, FF),
    each added when present.

    CUDA kernel ``csrc/moe_decode.cu``, which replaces the Pallas kernel
    ops/moe_decode.py:moe_decode_gate_up of the JAX package. Bound by the
    routed experts' code bytes: kernel 7's grid of (FF tiles, pairs) and
    one warp a column, a lane dequantizing 16 codes that share a scale to
    bf16 against the pair's bf16 row in shared memory."""
    if xp.device.type == "cpu":
        return moe_decode_gate_up_ref(xp, ids, gate_c, gate_s, up_c, up_s, gate_b, up_b,
                                      group=group, activation=activation,
                                      act_limit=act_limit)
    name = "moe_decode_gate_up"
    p, k = xp.shape
    f = gate_c.shape[2]
    _check_rows(name, xp, ids)
    _check_planar(name, gate_c, gate_s, k, group)
    _check_planar(name, up_c, up_s, k, group, f)
    _cuda.require(gate_s.dtype == up_s.dtype, f"{name}: gate and up scales of one dtype")
    for b in (gate_b, up_b):
        _cuda.require(b is None or (b.dtype == torch.float32 and b.is_contiguous()
                                    and b.shape == (gate_c.shape[0], f)),
                      f"{name}: biases must be contiguous f32 (G, FF)")
    for t in (ids, gate_c, gate_s, up_c, up_s, gate_b, up_b):
        _cuda.require(t is None or t.device == xp.device, f"{name}: operands on different devices")
    _cuda.require(activation in ACTIVATIONS and 2 * k <= SMEM_LIMIT,
                  f"{name}: activation {activation!r}, K {k}")
    h = torch.empty((p, f), dtype=torch.bfloat16, device=xp.device)
    fn = _cuda.function("moe_decode", "ik_moe_decode_gate_up",
                        [_cuda.P] * 6 + [_cuda.I] + [_cuda.P] * 3 + [_cuda.I] * 5
                        + [_cuda.F, _cuda.P])
    rc = fn(xp.data_ptr(), ids.data_ptr(), gate_c.data_ptr(), gate_s.data_ptr(),
            up_c.data_ptr(), up_s.data_ptr(), int(gate_s.dtype == torch.bfloat16),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), h.data_ptr(),
            p, k, f, group, ACTIVATIONS[activation], float(act_limit), _cuda.stream_ptr(xp))
    moe_decode_gate_up.launches += 1
    _cuda.check(rc, name)
    return h


moe_decode_gate_up.launches = 0


def moe_decode_down(hw, ids, down_c, down_s, *, top_k: int, group: int = 32):
    """Planar down projection summed over each token's top_k pairs: hw bf16
    (P, FF) with the routing weight folded in, ids int32 (P,), P = T *
    top_k, codes int8 (G, FF, E), scales f32 or bf16 (G, FF/group, E) ->
    f32 (T, E).

    CUDA kernel ``csrc/moe_decode.cu``, which replaces the Pallas kernel
    ops/moe_decode.py:moe_decode_down of the JAX package. Bound by the
    routed experts' down-code bytes: one block per (token, E tile) holds
    the token's rows in shared memory and adds its pairs in pair order in
    one thread's loop, with no atomics, so the sum is deterministic."""
    if hw.device.type == "cpu":
        return moe_decode_down_ref(hw, ids, down_c, down_s, top_k=top_k, group=group)
    name = "moe_decode_down"
    pp, f = hw.shape
    _cuda.require(pp % top_k == 0 and 2 * top_k * f <= SMEM_LIMIT,
                  f"{name}: {pp} pairs of width {f} for top_k {top_k}")
    _check_rows(name, hw, ids)
    _check_planar(name, down_c, down_s, f, group)
    for t in (ids, down_c, down_s):
        _cuda.require(t.device == hw.device, f"{name}: operands on different devices")
    e = down_c.shape[2]
    out = torch.empty((pp // top_k, e), dtype=torch.float32, device=hw.device)
    fn = _cuda.function("moe_decode", "ik_moe_decode_down",
                        [_cuda.P] * 4 + [_cuda.I, _cuda.P] + [_cuda.I] * 5 + [_cuda.P])
    rc = fn(hw.data_ptr(), ids.data_ptr(), down_c.data_ptr(), down_s.data_ptr(),
            int(down_s.dtype == torch.bfloat16), out.data_ptr(), pp // top_k, top_k, f, e,
            group, _cuda.stream_ptr(hw))
    moe_decode_down.launches += 1
    _cuda.check(rc, name)
    return out


moe_decode_down.launches = 0


def moe_decode(x, w, idx, experts, *, activation: str = "silu", act_limit: float = 0.0,
               weight_before_ffn: bool = False, plain: bool = False):
    """The decode FFN over planar experts (any group per projection, gate
    and up of one group): x (T, E), routing weights w (T, k), expert ids idx
    (T, k) -> f32 (T, E). Kernel 12 on the repeated bf16 rows, the routing
    weight folded into bf16 h, kernel 13, then the optional down bias.
    ``plain`` runs the plain versions on any device."""
    gate_up = moe_decode_gate_up_ref if plain else moe_decode_gate_up
    down = moe_decode_down_ref if plain else moe_decode_down
    t, k = idx.shape
    ids = idx.reshape(-1).to(torch.int32)
    xp = x.to(torch.bfloat16).repeat_interleave(k, dim=0)
    if weight_before_ffn:
        xp = xp * w.reshape(-1)[:, None].to(torch.bfloat16)
    h = gate_up(xp, ids, experts.gate, experts.gate_s, experts.up, experts.up_s,
                experts.gate_b, experts.up_b, group=experts.gate_group,
                activation=activation, act_limit=act_limit)
    if not weight_before_ffn:
        h = (h.float() * w.reshape(-1)[:, None]).to(torch.bfloat16)
    out = down(h, ids, experts.down, experts.down_s, top_k=k, group=experts.down_group)
    return _down_bias(out, experts, ids, w, weight_before_ffn)


def moe_decode_ref(x, w, idx, experts, *, activation: str = "silu",
                   act_limit: float = 0.0, weight_before_ffn: bool = False):
    """Plain version of the whole planar decode FFN (the JAX package's
    ``moe_decode_ref``): a dense gather and bf16 dequantization per pair."""
    return moe_decode(x, w, idx, experts, activation=activation, act_limit=act_limit,
                      weight_before_ffn=weight_before_ffn, plain=True)
