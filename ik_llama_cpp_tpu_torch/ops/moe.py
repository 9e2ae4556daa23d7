"""MoE routing and the routed-expert FFN.

The torch counterpart of the JAX package's ``ops/moe.py``. Experts are
``QuantExpertWeights`` (int8 codes, each projection with its own group:
re-coded per supergroup of 256 with f32 scales where its K allows, which is
the accelerator default at load, else planar with bf16 group scales) or
bf16 ``ExpertWeights`` (float GGUF tensors, asymmetric formats).

* decode (T <= 8, quantized, gate and up of one group): the int8 chain of
  ``ops/moe_decode.py`` when gate and down are both supergroup (two
  kernels, or one with ``IK_MOE_FUSED_TG=1`` where its shape rule holds),
  else the planar chain;
* prefill: rows sorted by expert; all-supergroup experts take the
  capacity-bucketed fused kernel of ``ops/moe_qmm.py`` with a ragged
  overflow pass; otherwise three grouped GEMMs, each projection on the
  int8 or the planar kernel by its own group; bf16 experts take plain
  products (the JAX package leaves them to ``lax.ragged_dot``).

The glue never reads the device back: group sizes come from
``scatter_add_``, row maps from ``searchsorted``, and the live expert count
stays a device scalar, so the eager decode loop is not stalled per layer.
Expert parallelism (``ep_axis``) waits for the multi-GPU slice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .moe_decode import SUPERGROUP, fused_decode_fits, moe_decode, moe_decode_i8
from .moe_decode import _act as _apply_moe_act
from .moe_qmm import (fused_moe_prefill_i8, fused_prefill_fits, ragged_qmatmul,
                      ragged_qmatmul_i8)
from .qmatmul import quantize_activations

GATING_SOFTMAX = 1
GATING_SIGMOID = 2
GATING_SOFTMAX_WEIGHT = 3   # softmax over the selected top-k only
GATING_SQRT_SOFTPLUS = 4    # deepseek4: sqrt(softplus(x))
DECODE_MAX_T = 8


def route(router_logits, n_expert_used: int, *, gating: int = GATING_SOFTMAX,
          norm_topk: bool = False, scale: float = 1.0, bias=None,
          selection_bias=None):
    """Returns (weights (T, k) f32, expert ids (T, k) int64), in the JAX
    package's order: gating -> optional selection bias -> top-k -> optional
    softmax over the selected -> optional normalization -> optional scale.
    Ties in top-k may order differently from ``jax.lax.top_k``."""
    logits = router_logits.float()
    if bias is not None:
        logits = logits + bias
    if gating == GATING_SOFTMAX:
        probs = torch.softmax(logits, dim=-1)
    elif gating == GATING_SIGMOID:
        probs = torch.sigmoid(logits)
    elif gating == GATING_SQRT_SOFTPLUS:
        probs = torch.sqrt(torch.nn.functional.softplus(logits))
    else:
        probs = logits
    sel = probs if selection_bias is None else probs + selection_bias
    idx = torch.topk(sel, n_expert_used, dim=-1).indices
    w = torch.gather(probs, -1, idx)
    if gating == GATING_SOFTMAX_WEIGHT:
        w = torch.softmax(w, dim=-1)
    if norm_topk:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
    if abs(scale - 1.0) > 1e-5:
        w = w * scale
    return w, idx


@dataclass
class ExpertWeights:
    """Stacked bf16 experts (dequantized at load): gate, up (G, E, FF) and
    down (G, FF, E); optional f32 per-expert biases gate_b / up_b (G, FF)
    and down_b (G, E)."""

    gate: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    gate_b: torch.Tensor | None = None
    up_b: torch.Tensor | None = None
    down_b: torch.Tensor | None = None


@dataclass
class QuantExpertWeights:
    """Stacked int8 experts: codes (G, K, N) with scales (G, K/group, N) for
    gate, up (K = E, N = FF) and down (K = FF, N = E), each projection with
    its own group: 256 with f32 scales (re-coded per supergroup) or the
    format's planar group with bf16 scales. Optional f32 per-expert biases
    gate_b / up_b (G, FF) and down_b (G, E). The loaders store each code
    tensor as a contiguous (G, N, K) tensor and hold its (G, K, N)
    transposed view here, the layout the kernels read."""

    gate: torch.Tensor
    gate_s: torch.Tensor
    up: torch.Tensor
    up_s: torch.Tensor
    down: torch.Tensor
    down_s: torch.Tensor
    gate_group: int = SUPERGROUP
    up_group: int = SUPERGROUP
    down_group: int = SUPERGROUP
    gate_b: torch.Tensor | None = None
    up_b: torch.Tensor | None = None
    down_b: torch.Tensor | None = None

    @property
    def supergroup(self) -> bool:
        return self.gate_group == self.up_group == self.down_group == SUPERGROUP


def _fused_tg_enabled() -> bool:
    """IK_MOE_FUSED_TG=1 opts into the single-kernel decode (kernel 11);
    read at call time, off by default as in the JAX package."""
    return os.environ.get("IK_MOE_FUSED_TG", "0") not in ("0", "false", "")


def _fused_prefill_try(xs, group_sizes, experts: QuantExpertWeights,
                       activation: str, act_limit: float):
    """Capacity-bucketed whole-FFN prefill (kernel 9) with the ragged
    overflow pass (kernel 10, three launches). Returns y f32 (M, E) for the
    sorted rows, or None when a projection is not supergroup, the fused
    kernel does not take the shapes or the experts carry gate/up biases;
    the caller then runs the ragged chain. The same routing by shape as the
    JAX package's, with the kernel's own shape rule."""
    m, k = xs.shape
    g, _, f = experts.gate.shape
    # capacity ~1.25x the mean rows per expert, 8-aligned
    r = min(512, max(8, (-(-(m * 5) // (g * 4)) + 7) // 8 * 8))
    if (not experts.supergroup or experts.gate_b is not None or experts.up_b is not None
            or not fused_prefill_fits(r, k, f)):
        return None
    dev = xs.device
    gs = group_sizes.to(torch.int32)
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    starts = ends - gs
    xq, xsc = quantize_activations(xs)               # (M, K) i8, (M, K/256)

    ar_r = torch.arange(r, dtype=torch.int32, device=dev)
    valid = ar_r[None, :] < gs[:, None]
    safe = torch.where(valid, starts[:, None] + ar_r[None, :], 0).clamp(0, m - 1).long()
    xg = torch.where(valid[..., None], xq[safe], 0).to(torch.int8)          # (G, R, K)
    xst_g = torch.where(valid[..., None], xsc[safe], 0.0).transpose(1, 2)   # (G, K/256, R)
    ar_g = torch.arange(g, dtype=torch.int32, device=dev)
    eids = torch.argsort(torch.where(gs > 0, ar_g, 2 * g)).to(torch.int32)
    n_live = torch.sum(gs > 0).to(torch.int32)

    y1 = fused_moe_prefill_i8(xg, xst_g, eids, n_live, experts.gate, experts.gate_s,
                              experts.up, experts.up_s, experts.down, experts.down_s,
                              capacity=r, activation=activation, act_limit=act_limit)
    e = y1.shape[-1]

    # each sorted row's expert and rank, and its slot in the buckets
    ar_m = torch.arange(m, dtype=torch.int32, device=dev)
    rid = torch.searchsorted(ends, ar_m, right=True).clamp(max=g - 1)
    rank = ar_m - starts[rid]
    from_p1 = rank < r
    slot = (rid * r + rank).clamp(0, g * r - 1)
    y = y1.reshape(g * r, e)[slot]

    # overflow pass: rows of rank >= R, compacted and regrouped
    leftover = torch.clamp(gs - r, min=0)
    l_ends = torch.cumsum(leftover, 0, dtype=torch.int32)
    l_starts = l_ends - leftover
    rid2 = torch.searchsorted(l_ends, ar_m, right=True).clamp(max=g - 1)
    src2 = (starts[rid2] + r + (ar_m - l_starts[rid2])).clamp(0, m - 1)
    xq2, xsc2 = xq[src2], xsc[src2]
    g2 = ragged_qmatmul_i8(xq2, xsc2.t(), experts.gate, experts.gate_s, leftover)
    u2 = ragged_qmatmul_i8(xq2, xsc2.t(), experts.up, experts.up_s, leftover)
    h2 = _apply_moe_act(g2, u2, activation, act_limit)
    hq2, hs2 = quantize_activations(h2.to(torch.bfloat16))
    y2 = ragged_qmatmul_i8(hq2, hs2.t(), experts.down, experts.down_s, leftover)
    pos2 = (l_starts[rid] + (rank - r)).clamp(0, m - 1)
    return torch.where(from_p1[:, None], y, y2[pos2])


def _ragged_qmm(xs, codes, scale, group_sizes, group: int):
    """One grouped GEMM of the sorted bf16 rows: supergroup codes take the
    int8 kernel 10 (rows quantized per (row, supergroup) here), any other
    group the planar kernel 14."""
    if group == SUPERGROUP:
        xq, xsc = quantize_activations(xs)
        return ragged_qmatmul_i8(xq, xsc.t(), codes, scale, group_sizes)
    return ragged_qmatmul(xs, codes, scale, group_sizes, group=group)


def _ragged_chain(xs, group_sizes, sorted_ids, experts: QuantExpertWeights,
                  activation: str, act_limit: float):
    """The three-GEMM ragged prefill, each projection by its own group."""
    gs = group_sizes.to(torch.int32)
    g = _ragged_qmm(xs, experts.gate, experts.gate_s, gs, experts.gate_group)
    u = _ragged_qmm(xs, experts.up, experts.up_s, gs, experts.up_group)
    if experts.gate_b is not None:
        g = g + experts.gate_b[sorted_ids]
    if experts.up_b is not None:
        u = u + experts.up_b[sorted_ids]
    h = _apply_moe_act(g, u, activation, act_limit).to(torch.bfloat16)
    return _ragged_qmm(h, experts.down, experts.down_s, gs, experts.down_group)


def _grouped_dense(xs, w, sorted_ids):
    """Sorted rows xs (M, K) against bf16 experts w (G, K, N), each row with
    its own expert: f32 (M, N). One masked product per expert (a zero row
    adds exactly nothing), so nothing is read back from the device; bf16
    operands, float32 sums."""
    xf = xs.to(w.dtype).float()
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=torch.float32, device=xs.device)
    for g in range(w.shape[0]):
        out += torch.where((sorted_ids == g)[:, None], xf, 0.0) @ w[g].float()
    return out


def _dense_chain(xs, sorted_ids, experts: ExpertWeights, activation: str, act_limit: float):
    """The sorted prefill and decode path of bf16 experts."""
    g = _grouped_dense(xs, experts.gate, sorted_ids)
    u = _grouped_dense(xs, experts.up, sorted_ids)
    if experts.gate_b is not None:
        g = g + experts.gate_b[sorted_ids]
    if experts.up_b is not None:
        u = u + experts.up_b[sorted_ids]
    h = _apply_moe_act(g, u, activation, act_limit)
    return _grouped_dense(h, experts.down, sorted_ids)


def moe_ffn(x, router_logits, experts, n_expert_used: int, *,
            gating: int = GATING_SOFTMAX, norm_topk: bool = False,
            scale: float = 1.0, selection_bias=None, activation: str = "silu",
            weight_before_ffn: bool = False, act_limit: float = 0.0,
            expert_out_scale=None):
    """x (T, E) -> f32 (T, E): route, then a decode chain for T <= 8 over
    quantized experts or the sorted path. ``weight_before_ffn`` scales each
    expert's input by its routing weight and sums the outputs unweighted
    (llama4); ``expert_out_scale`` (G,) folds a per-expert scalar into the
    routing weight of each selected expert (gemma4)."""
    t, e = x.shape
    k = n_expert_used
    n_expert = experts.gate.shape[0]
    w, idx = route(router_logits, k, gating=gating, norm_topk=norm_topk,
                   scale=scale, selection_bias=selection_bias)
    if expert_out_scale is not None:
        w = w * expert_out_scale.to(w.dtype)[idx]
    quant = isinstance(experts, QuantExpertWeights)
    if quant and t <= DECODE_MAX_T and experts.gate_group == experts.up_group:
        kw = dict(activation=activation, act_limit=act_limit,
                  weight_before_ffn=weight_before_ffn)
        if experts.gate_group == SUPERGROUP and experts.down_group == SUPERGROUP:
            fused = _fused_tg_enabled() and fused_decode_fits(
                e, experts.gate.shape[2], k)
            return moe_decode_i8(x, w, idx, experts, fused=fused, **kw)
        return moe_decode(x, w, idx, experts, **kw)

    flat_ids = idx.reshape(-1)                        # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    inv_order = torch.argsort(order)
    xs = x.repeat_interleave(k, dim=0)[order]
    if weight_before_ffn:
        xs = xs * w.reshape(-1)[order][:, None]
    sorted_ids = flat_ids[order]
    if quant:
        xs = xs.to(torch.bfloat16)
        group_sizes = torch.zeros(n_expert, dtype=torch.int32, device=x.device)
        group_sizes.scatter_add_(0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32))
        y = _fused_prefill_try(xs, group_sizes, experts, activation, act_limit)
        if y is None:
            y = _ragged_chain(xs, group_sizes, sorted_ids, experts, activation, act_limit)
    else:
        y = _dense_chain(xs, sorted_ids, experts, activation, act_limit)
    if experts.down_b is not None:
        y = y + experts.down_b[sorted_ids]
    y = y[inv_order].reshape(t, k, e)
    if weight_before_ffn:
        return torch.sum(y, dim=1)
    return torch.sum(y * w[:, :, None], dim=1)
