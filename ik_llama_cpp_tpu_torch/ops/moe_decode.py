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


DOWN_THREADS = 256        # threads of a down-kernel block (8 warps)
DOWN_COLS = 8             # adjacent output columns a down-kernel block takes at least


def down_plan(t: int, top_k: int, f: int, e: int, group: int | None = None,
              cols: int | None = None) -> dict:
    """Launch shape of the down kernels, 8 (``group`` None: int8 rows of
    supergroup codes) and 13 (planar rows of ``group``-wide scales).

    A block takes one token's top_k pairs over ``cols`` adjacent output
    columns: top_k * cols rows of f codes, one expert column each, which its
    DOWN_THREADS threads split ``lanes`` lanes a row. Lane l of a row loads
    the row's 16-byte chunks l, l + lanes, ... (``chunks`` of them) with
    unconditional loads that stay in flight together; at the main shapes
    every row of the block is in flight in one pass (some 45-48 KB a block,
    ~2 blocks an SM at T = 1). ``cols`` is the least power of two from
    DOWN_COLS up that fills the block; ``lanes`` the most (up to 16 for
    int8, where a lane's chunks must not straddle a 256-deep supergroup,
    else 32, and at most the row's chunks) that keeps the rows in one pass.
    The block's shared memory is laid out and sized by the C entry point,
    which refuses a shape that does not fit."""
    nch = f // 16
    most = 16 if group is None else 32
    if cols is None:
        cols = DOWN_COLS
        while top_k * cols * most < DOWN_THREADS:
            cols *= 2
    rows = top_k * cols
    lanes = 1
    while 2 * lanes <= min(most, nch) and 2 * lanes * rows <= DOWN_THREADS:
        lanes *= 2
    tiles = -(-e // cols)
    return {"cols": cols, "lanes": lanes, "tiles": tiles, "blocks": tiles * t,
            "passes": -(-rows // (DOWN_THREADS // lanes)), "chunks": -(-nch // lanes)}


GATE_UP_THREADS = 256     # threads of a kernel-7 or kernel-12 block (8 warps)
GATE_UP_COLS = 4          # adjacent FF columns a block takes at least
GATE_UP_LANES = 8         # lanes a row from which the columns that fill a block are set


def _gate_up_rows(p: int, k: int, ff: int, cols: int | None, most: int) -> dict:
    """The block shape of kernels 7 and 12: ``cols`` the least power of two
    from GATE_UP_COLS up that fills the block at GATE_UP_LANES lanes a row
    (at most the row's chunks), unless forced; ``lanes`` the most, up to
    ``most``, that keeps the block's 2 * cols rows in one pass."""
    nch = k // 16
    if cols is None:
        fill = min(GATE_UP_LANES, nch)
        cols = GATE_UP_COLS
        while 2 * cols * fill < GATE_UP_THREADS:
            cols *= 2
    rows = 2 * cols
    lanes = 1
    while 2 * lanes <= min(most, nch) and 2 * lanes * rows <= GATE_UP_THREADS:
        lanes *= 2
    tiles = -(-ff // cols)
    return {"cols": cols, "lanes": lanes, "tiles": tiles, "blocks": tiles * p,
            "passes": -(-rows // (GATE_UP_THREADS // lanes)), "chunks": -(-nch // lanes)}


def gate_up_plan(p: int, k: int, ff: int, cols: int | None = None) -> dict:
    """Launch shape of kernel 12 (planar gate/up): a block takes one pair
    over ``cols`` adjacent FF columns, its 2 * cols gate and up rows of k
    codes, which its GATE_UP_THREADS threads split ``lanes`` lanes a row
    (up to 32), all rows in one pass; a lane streams its ``chunks`` 16-byte
    chunks through a ring of 4 loads in flight. At K 2048: 16 columns, 8
    lanes a row, 16 chunks a lane (16 columns a block timed fastest,
    chip_smoke.py's column sweep). The C entry point lays out and sizes the
    block's shared memory (the pair's bf16 row and the 2 * cols dots) and
    refuses a shape that does not fit."""
    return _gate_up_rows(p, k, ff, cols, 32)


def gate_up_i8_plan(p: int, k: int, ff: int, cols: int | None = None) -> dict:
    """Launch shape of kernel 7 (int8 gate/up), kernel 12's plan with at
    most 16 lanes a row, so that a lane's chunks never straddle a 256-deep
    supergroup (it holds 16 / lanes chunks of each, and a shuffle over the
    row's lanes forms each supergroup's exact sum): at K 2048 16 columns, 8
    lanes a row, 16 chunks a lane. ``cols`` is forced by chip_smoke.py's
    column sweep. The C entry point sizes the block's shared memory (the
    pair's xq row and scales, the weight scales and the sums) and refuses a
    shape that does not fit."""
    _cuda.require(k % SUPERGROUP == 0 and k >= SUPERGROUP,
                  f"gate_up_i8_plan: K={k} must be a positive multiple of 256")
    return _gate_up_rows(p, k, ff, cols, 16)


def moe_decode_gate_up_i8(xq, xst, ids, gate_c, gate_sw, up_c, up_sw,
                          gate_b=None, up_b=None, *,
                          activation: str = "silu", act_limit: float = 0.0):
    """Routed gate/up matvecs + activation: xq int8 (P, K), xst f32
    (K/256, P), ids int32 (P,) -> h bf16 (P, FF). Optional per-expert
    biases gate_b / up_b f32 (G, FF).

    CUDA kernel ``csrc/moe_decode_i8.cu`` (``gate_up_i8_kernel``), which
    replaces the Pallas kernel ops/moe_decode.py:moe_decode_gate_up_i8 of
    the JAX package. Bound by the routed experts' code bytes: a block takes
    one pair's gate and up rows over a few FF columns (``gate_up_i8_plan``),
    all in flight at once, each lane streaming its 16-byte loads through a
    ring of 4 into __dp4a against the pair's int8 row in shared memory; a
    shuffle over a row's lanes forms each supergroup's exact sum, and one
    thread a column adds the corrections in supergroup order, the bias and
    the activation."""
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
    plan = gate_up_i8_plan(p, k, f)
    h = torch.empty((p, f), dtype=torch.bfloat16, device=xq.device)
    fn = _cuda.function("moe_decode_i8", "ik_moe_decode_gate_up_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 8
                        + [_cuda.I] * 4 + [_cuda.F] + [_cuda.I] * 2 + [_cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1), ids.data_ptr(),
            gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(), up_sw.data_ptr(),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), h.data_ptr(),
            p, k, f, ACTIVATIONS[activation], float(act_limit), plan["cols"], plan["lanes"],
            _cuda.stream_ptr(xq))
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
    routed experts' down-code bytes: one block per (token, column tile)
    loads all of the token's pairs' rows at once (``down_plan``), keeps each
    supergroup's exact int32 dot, and adds the float corrections pair by
    pair, supergroup by supergroup, in one thread a column: the plain
    version's order, with no atomics."""
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
    plan = down_plan(pp // top_k, top_k, f, e)
    out = torch.empty((pp // top_k, e), dtype=torch.float32, device=hq.device)
    fn = _cuda.function("moe_decode_i8", "ik_moe_decode_down_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 4
                        + [_cuda.I] * 6 + [_cuda.P])
    rc = fn(hq.data_ptr(), hst.data_ptr(), hst.stride(0), hst.stride(1), ids.data_ptr(),
            down_c.data_ptr(), down_sw.data_ptr(), out.data_ptr(),
            pp // top_k, top_k, f, e, plan["cols"], plan["lanes"], _cuda.stream_ptr(hq))
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


FUSED_COLS = 16          # FF columns of a phase-1 item of kernel 11 (its 32 gate and up rows)
def fused_decode_plan(t: int, top_k: int, ff: int, e: int) -> dict:
    """The launch of kernel 11 (``csrc/moe_decode_fused_i8.cu``) for T
    tokens: one block a work item, dealt in ticket order. Tickets
    0 .. ``items1`` - 1 are the phase-1 items (pair p, FUSED_COLS columns of
    FF from f0), pair-major; the next ``items2`` the phase-2 items (token t,
    ``cols`` columns of E from n0: kernel 8's block, ``down_plan``),
    token-major. ``counters``: the ticket, the blocks done, one a (pair, FF
    supergroup), one a token."""
    d = down_plan(t, top_k, ff, e)
    p = t * top_k
    items1 = p * (ff // FUSED_COLS)
    return {"items1": items1, "items2": t * d["tiles"], "blocks": items1 + t * d["tiles"],
            "n_ft": ff // FUSED_COLS, "tiles": d["tiles"], "cols": d["cols"],
            "lanes": d["lanes"], "counters": 2 + p * (ff // SUPERGROUP) + t}


def fused_decode_item(plan: dict, ticket: int) -> tuple:
    """What the block holding ``ticket`` computes, as the kernel decodes it:
    (1, pair, f0) or (2, token, n0)."""
    if ticket < plan["items1"]:
        return 1, ticket // plan["n_ft"], ticket % plan["n_ft"] * FUSED_COLS
    i = ticket - plan["items1"]
    return 2, i // plan["tiles"], i % plan["tiles"] * plan["cols"]


def fused_decode_smem_bytes(k: int, ff: int, top_k: int) -> int:
    """Dynamic shared memory of a block of csrc/moe_decode_fused_i8.cu: the
    larger of phase 1's activation row with its supergroup scales and
    phase 2's scales of h, down scales and int32 sums (h itself is read
    from L2)."""
    cols = down_plan(1, top_k, ff, 1)["cols"]
    return max(k + k // SUPERGROUP * 4, 4 * top_k * (ff // SUPERGROUP) * (1 + 2 * cols))


def fused_decode_fits(k: int, ff: int, top_k: int) -> bool:
    """Whether kernel 11 takes these shapes, decided from shapes alone (the
    counterpart of the JAX kernel returning None): supergroup K and FF and
    a block's shared memory within the limit. Models that fail it take the
    two-kernel chain."""
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
    by the routed experts' code bytes: one block a work item from a ticket
    counter (``fused_decode_plan``), the phase-1 items (a pair's gate and up
    rows of 16 columns in flight at once) before the phase-2 items (kernel
    8's block, its down loads issued before it waits for its token's h); h
    requantized once a (pair, supergroup) by the block that completes it,
    into an int8 scratch that stays in L2; no float atomics."""
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
    plan = fused_decode_plan(p // top_k, top_k, f, e)
    hbuf = torch.empty((p, f), dtype=torch.bfloat16, device=xq.device)
    hq = torch.empty((p, f), dtype=torch.int8, device=xq.device)
    hs = torch.empty((p, f // SUPERGROUP), dtype=torch.float32, device=xq.device)
    counters = _cuda.zeroed_counters(xq.device, name, plan["counters"])
    out = torch.empty((p // top_k, e), dtype=torch.float32, device=xq.device)
    fn = _cuda.function("moe_decode_fused_i8", "ik_moe_decode_fused_i8",
                        [_cuda.P, _cuda.P, _cuda.I, _cuda.I] + [_cuda.P] * 15
                        + [_cuda.I] * 8 + [_cuda.F, _cuda.P])
    rc = fn(xq.data_ptr(), xst.data_ptr(), xst.stride(0), xst.stride(1), ids.data_ptr(),
            wts.data_ptr(), gate_c.data_ptr(), gate_sw.data_ptr(), up_c.data_ptr(),
            up_sw.data_ptr(), down_c.data_ptr(), down_sw.data_ptr(),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), hbuf.data_ptr(), hq.data_ptr(),
            hs.data_ptr(), counters.data_ptr(), out.data_ptr(),
            p, top_k, k, f, e, plan["cols"], plan["lanes"], ACTIVATIONS[activation],
            float(act_limit), _cuda.stream_ptr(xq))
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
    routed experts' code bytes: a block takes one pair's gate and up rows
    over a few FF columns (``gate_up_plan``), all in flight at once, each
    lane streaming its 16-byte code loads through a ring of 4; it
    dequantizes them to bf16 with no conversion instruction against the
    pair's bf16 row in shared memory, and one thread a column applies the
    activation."""
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
    plan = gate_up_plan(p, k, f)
    _cuda.require(activation in ACTIVATIONS and 2 * k + 8 * plan["cols"] <= SMEM_LIMIT,
                  f"{name}: activation {activation!r}, K {k}")
    h = torch.empty((p, f), dtype=torch.bfloat16, device=xp.device)
    fn = _cuda.function("moe_decode", "ik_moe_decode_gate_up",
                        [_cuda.P] * 6 + [_cuda.I] + [_cuda.P] * 3 + [_cuda.I] * 5
                        + [_cuda.F, _cuda.I, _cuda.I, _cuda.P])
    rc = fn(xp.data_ptr(), ids.data_ptr(), gate_c.data_ptr(), gate_s.data_ptr(),
            up_c.data_ptr(), up_s.data_ptr(), int(gate_s.dtype == torch.bfloat16),
            None if gate_b is None else gate_b.data_ptr(),
            None if up_b is None else up_b.data_ptr(), h.data_ptr(),
            p, k, f, group, ACTIVATIONS[activation], float(act_limit), plan["cols"],
            plan["lanes"], _cuda.stream_ptr(xp))
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
    routed experts' down-code bytes: one block per (token, column tile)
    loads all of the token's pairs' rows at once (``down_plan``), forms each
    pair's column dot, and adds the pairs in pair order in one thread a
    column, with no atomics, so the sum is deterministic."""
    if hw.device.type == "cpu":
        return moe_decode_down_ref(hw, ids, down_c, down_s, top_k=top_k, group=group)
    name = "moe_decode_down"
    pp, f = hw.shape
    _cuda.require(pp % top_k == 0, f"{name}: {pp} pairs for top_k {top_k}")
    _check_rows(name, hw, ids)
    _check_planar(name, down_c, down_s, f, group)
    for t in (ids, down_c, down_s):
        _cuda.require(t.device == hw.device, f"{name}: operands on different devices")
    e = down_c.shape[2]
    plan = down_plan(pp // top_k, top_k, f, e, group)
    out = torch.empty((pp // top_k, e), dtype=torch.float32, device=hw.device)
    fn = _cuda.function("moe_decode", "ik_moe_decode_down",
                        [_cuda.P] * 4 + [_cuda.I, _cuda.P] + [_cuda.I] * 7 + [_cuda.P])
    rc = fn(hw.data_ptr(), ids.data_ptr(), down_c.data_ptr(), down_s.data_ptr(),
            int(down_s.dtype == torch.bfloat16), out.data_ptr(), pp // top_k, top_k, f, e,
            group, plan["cols"], plan["lanes"], _cuda.stream_ptr(hw))
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
