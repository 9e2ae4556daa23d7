"""Qwen3-Next and Qwen3.5: the hybrid gated-delta-net / full-attention
family (qwen3next, qwen35, qwen35moe) on a recurrent cache.

The torch counterpart of the JAX package's ``models/qwen3next.py``,
function by function (build_qwen3next and the delta_net builders of the
reference):
  * layers with (il+1) % interval != 0 are RECURRENT (gated delta net):
    ssm_in projects per-k-head interleaved [q|k|v|z] (qwen35: a flat
    [q|k|v] attn_qkv and a whole-width attn_gate z); beta/alpha from
    ssm_ba (per-k-head [b|a]; qwen35: ssm_beta / ssm_alpha, GQA repeat 1);
    gate g = ssm_a * softplus(alpha + dt_b); a causal depthwise conv + silu
    over [q|k|v] with the last d_conv - 1 inputs carried; per-head l2-norm
    of q/k; the recurrence (``ops/delta_net.py``); the output gated by
    rms_norm(o) * silu(z), then ssm_out
  * every interval-th layer is full attention with a gated q (wq holds
    per-head [q|gate]; the output is scaled by sigmoid(gate) before wo;
    qwen35 files may carry a plain q), q/k norms, partial NEOX rope (imrope
    for qwen35)
  * every layer: a softmax top-k MoE FFN with normalized weights and an
    optional sigmoid-gated shared expert (qwen35: a dense FFN);
    post_attention_norm is the FFN norm

``HybridCache`` holds the JAX layout: k/v rows of every layer (read by the
attention layers only), and the recurrent layers' conv tail and delta
state, each with the batch on axis 1. The forward writes all four in
place. ``n_valid`` (an int, or one length a batch row) bounds what a
bucket-padded chunk commits to the recurrent state: past it beta is -inf
and g is 0, so the state is left exactly as it was, and the conv tail is
sliced at it. A row with ``n_valid`` 0 keeps its conv tail and state bit
for bit; its attention rows land where the caller points them, as
padded rows do everywhere.

The attention runs on the port's kernels as ``models/llama.py`` dispatches
them: the prefill kernel B above ``DECODE_MAX_T`` rows, the decode kernel C
at or below, their plain versions on the CPU (the JAX package calls its
Pallas prefill kernel at every T). The recurrence and the conv are plain
PyTorch, as they are XLA in the JAX package.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.delta_net import delta_net
from ..ops.flash_attention import DECODE_MAX_T, flash_attention, flash_attention_decode
from ..ops.moe import moe_ffn
from .config import ModelConfig
from .llama import _EXPERT_TENSORS, _load_experts, refuse_hidden
from .weights import _t, dequant_tensor, load_dense, load_linear

ARCHS = ("qwen3next", "qwen35", "qwen35moe")


def is_recurrent(il: int, interval: int = 4) -> bool:
    return (il + 1) % interval != 0


def _interval(cfg: ModelConfig) -> int:
    return int(cfg.extra.get("full_attn_interval", 4))


@dataclass
class HybridCache:
    """k/v: (L, B, S, Hkv, D) bf16, written and read by the attention layers
    only; conv: (L, B, d_conv - 1, conv_dim) float32; state: (L, B, Hv, Dv,
    Dv) float32. Written in place."""

    k: torch.Tensor
    v: torch.Tensor
    conv: torch.Tensor
    state: torch.Tensor

    # the tensors whose axis 1 is the batch (the server's row views)
    ROW_FIELDS = ("k", "v", "conv", "state")

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k.device

    def zero_row(self, row: int) -> None:
        """Reset one batch row's recurrent state (conv tail and delta
        state) to a fresh sequence's."""
        self.conv[:, row].zero_()
        self.state[:, row].zero_()

    def checkpoint(self) -> tuple:
        """A copy of what a speculative verify may have to undo: every row's
        conv tail and delta state (the k/v rows are cut back by n_past
        alone). The cache is written in place, so a reference would not
        do."""
        return self.conv.clone(), self.state.clone()

    def restore(self, ckpt: tuple, row: int | None = None) -> None:
        """Put back a checkpoint's conv tails and delta states: every row's,
        or one batch row's."""
        conv, state = ckpt
        if row is None:
            self.conv.copy_(conv)
            self.state.copy_(state)
        else:
            self.conv[:, row] = conv[:, row]
            self.state[:, row] = state[:, row]

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, device, quant=False):
        """The cache is bf16 k/v beside float32 recurrent state: ``quant``
        has no effect on this family, as in the JAX package, and is logged."""
        if quant:
            logging.getLogger("ik_llama_cpp_tpu_torch").warning(
                "KV cache type %r has no effect on %s: its cache is bf16", quant, cfg.arch)
        head_v_dim = cfg.ssm_d_inner // cfg.ssm_dt_rank
        conv_dim = 2 * cfg.ssm_d_state * cfg.ssm_n_group + cfg.ssm_d_inner
        kv_shape = (cfg.n_layer, batch, capacity, cfg.n_head_kv, cfg.head_dim)
        return cls(
            torch.zeros(kv_shape, dtype=torch.bfloat16, device=device),
            torch.zeros(kv_shape, dtype=torch.bfloat16, device=device),
            torch.zeros((cfg.n_layer, batch, cfg.ssm_d_conv - 1, conv_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layer, batch, cfg.ssm_dt_rank, head_v_dim, head_v_dim),
                        dtype=torch.float32, device=device))


def load_qwen3next_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                          use_quant: bool = True) -> dict:
    """GGUF -> nested dict of device tensors and linear modules, the JAX
    loader's tree. The routers and the beta/alpha projections stay bf16
    dense products, as in the JAX package. Every ``blk.N.*`` tensor is
    consumed or refused."""
    t = gg.tensors
    used: set = set()

    def take(name: str):
        used.add(name)
        return t[name]

    def linear(name: str, quant: bool = use_quant):
        return load_linear(take(name), device, use_quant=quant)

    def dense(name: str):
        return load_dense(take(name), device)

    params: dict = {
        "tok_embd": _t(dequant_tensor(take("token_embd.weight")), device, torch.bfloat16),
        "output_norm": dense("output_norm.weight"),
        "output": linear("output.weight" if "output.weight" in t else "token_embd.weight")}
    blocks = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        # post_attention_norm doubles as the FFN norm
        blk = {"attn_norm": dense(p + "attn_norm.weight"),
               "ffn_norm": dense(p + "post_attention_norm.weight")}
        if is_recurrent(i, _interval(cfg)):
            if p + "ssm_in.weight" in t:          # fused per-k-head [q|k|v|z]
                blk["ssm_in"] = linear(p + "ssm_in.weight")
            else:                                 # qwen35: flat [q|k|v] + z gate
                blk["wqkv_lin"] = linear(p + "attn_qkv.weight")
                blk["wqkv_gate"] = linear(p + "attn_gate.weight")
            blk["ssm_conv1d"] = _t(dequant_tensor(take(p + "ssm_conv1d.weight")).reshape(
                -1, cfg.ssm_d_conv), device, torch.float32)       # (conv_dim, d_conv)
            blk["ssm_dt_b"] = dense(p + "ssm_dt.bias")
            blk["ssm_a"] = dense(p + "ssm_a")
            if p + "ssm_ba.weight" in t:
                blk["ssm_ba"] = linear(p + "ssm_ba.weight", False)
            else:                                 # qwen35: separate beta / alpha
                blk["ssm_beta"] = linear(p + "ssm_beta.weight", False)
                blk["ssm_alpha"] = linear(p + "ssm_alpha.weight", False)
            blk["ssm_norm"] = dense(p + "ssm_norm.weight")
            blk["ssm_out"] = linear(p + "ssm_out.weight")
        else:
            for key, name in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                              ("wo", "attn_output")):
                blk[key] = linear(p + name + ".weight")
            blk["attn_q_norm"] = dense(p + "attn_q_norm.weight")
            blk["attn_k_norm"] = dense(p + "attn_k_norm.weight")
        if p + "ffn_gate_inp.weight" in t:
            blk["ffn_gate_inp"] = linear(p + "ffn_gate_inp.weight", False)
            used.update(p + nm for nm in _EXPERT_TENSORS if p + nm in t)
            blk["experts"] = _load_experts(t, p, device, use_quant=use_quant)
            if p + "ffn_gate_shexp.weight" in t:
                for name in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                    blk[name] = linear(p + name + ".weight")
                if p + "ffn_gate_inp_shexp.weight" in t:
                    blk["ffn_gate_inp_shexp"] = linear(p + "ffn_gate_inp_shexp.weight", False)
        else:
            for name in ("ffn_gate", "ffn_up", "ffn_down"):
                blk[name] = linear(p + name + ".weight")
        blocks.append(blk)
    for name in t:
        if name.startswith("blk.") and name not in used:
            raise NotImplementedError(
                f"tensor {name!r}: the {cfg.arch} graph does not apply it")
    params["blocks"] = blocks
    return params


def _l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _delta_layer(blk: dict, h: torch.Tensor, cfg: ModelConfig, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Gated delta-net sublayer over normalized h (B, T, E). Writes the new
    conv tail and delta state into ``conv_state`` / ``ssm_state`` (views of
    the cache) in place; rows past ``n_valid`` (B,) leave both as they
    were. Returns the float32 output (B, T, E)."""
    b, t, _ = h.shape
    dk, hk, hv = cfg.ssm_d_state, cfg.ssm_n_group, cfg.ssm_dt_rank
    dv = cfg.ssm_d_inner // hv
    r = hv // hk
    key_dim, value_dim = dk * hk, dv * hv
    eps = cfg.rms_eps

    if "ssm_in" in blk:
        # per-k-head interleaved [q(dk) | k(dk) | v(dv*r) | z(dv*r)]
        mixed = blk["ssm_in"](h).reshape(b, t, hk, 2 * dk + 2 * dv * r)
        q = mixed[..., :dk]
        k = mixed[..., dk:2 * dk]
        v = mixed[..., 2 * dk:2 * dk + dv * r]
        z = mixed[..., 2 * dk + dv * r:].reshape(b, t, hv, dv)
        qkv = torch.cat([q.reshape(b, t, key_dim), k.reshape(b, t, key_dim),
                         v.reshape(b, t, value_dim)], dim=-1)
    else:
        qkv = blk["wqkv_lin"](h)
        z = blk["wqkv_gate"](h).reshape(b, t, hv, dv)

    if "ssm_ba" in blk:
        # per-k-head interleaved [b(r) | a(r)] -> repeat type 0
        ba = blk["ssm_ba"](h).reshape(b, t, hk, 2 * r)
        beta = ba[..., :r].reshape(b, t, hv)
        alpha = ba[..., r:].reshape(b, t, hv)
        repeat_type = 0
    else:
        beta = blk["ssm_beta"](h)
        alpha = blk["ssm_alpha"](h)
        repeat_type = 1
    g = blk["ssm_a"] * torch.nn.functional.softplus(alpha.float() + blk["ssm_dt_b"])

    # the causal conv over [q | k | v] with the carried tail, then silu
    xpad = torch.cat([conv_state, qkv.float()], dim=1)       # (B, d_conv - 1 + T, C)
    w = blk["ssm_conv1d"]                                     # (C, d_conv)
    y = xpad[:, 0:t] * w[:, 0]
    for i in range(1, cfg.ssm_d_conv):
        y = y + xpad[:, i:i + t] * w[:, i]
    tail = n_valid.long()[:, None] + torch.arange(cfg.ssm_d_conv - 1, device=h.device)
    conv_state.copy_(torch.gather(xpad, 1, tail[:, :, None].expand(-1, -1, xpad.shape[2])))
    y = y * torch.sigmoid(y)

    qc = _l2_norm(y[..., :key_dim].reshape(b, t, hk, dk), eps)
    kc = _l2_norm(y[..., key_dim:2 * key_dim].reshape(b, t, hk, dk), eps)
    vc = y[..., 2 * key_dim:].reshape(b, t, hv, dv)

    # past n_valid: sigmoid(beta) = 0 and decay = 1 leave the state as it was
    live = (torch.arange(t, device=h.device)[None, :] < n_valid[:, None])[..., None]
    beta = torch.where(live, beta, torch.full_like(beta, -1e30))
    g = torch.where(live, g, torch.zeros_like(g))
    out, new_state = delta_net(qc, kc, vc, g, beta, ssm_state, repeat_type=repeat_type)
    ssm_state.copy_(new_state)

    # gated output: rms_norm(o) * silu(z), then ssm_out
    o = L.rms_norm(out, blk["ssm_norm"], eps)
    zf = z.float()
    o = (o * (zf * torch.sigmoid(zf))).reshape(b, t, value_dim)
    return blk["ssm_out"](o.to(torch.bfloat16))


def _gated_attention(blk: dict, h: torch.Tensor, cfg: ModelConfig, k_slab: torch.Tensor,
                     v_slab: torch.Tensor, n_past: list, npv: torch.Tensor, cos,
                     sin) -> torch.Tensor:
    """Full-attention sublayer over normalized h (B, T, E) with a per-head
    [q | gate] projection (or a plain q). Writes this chunk's K/V rows into
    the layer's slabs (B, S, Hkv, D) in place at each row's n_past."""
    b, t, _ = h.shape
    nh, hkv, d = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    qg = blk["wq"](h)
    if qg.shape[-1] == nh * 2 * d:
        qg = qg.reshape(b, t, nh, 2 * d)
        q, gate = qg[..., :d], qg[..., d:]
    else:
        q, gate = qg.reshape(b, t, nh, d), None
    k = blk["wk"](h).reshape(b, t, hkv, d)
    v = blk["wv"](h).reshape(b, t, hkv, d)
    q = L.apply_rope(L.rms_norm(q, blk["attn_q_norm"], cfg.rms_eps), cos, sin, cfg.rope_type)
    k = L.apply_rope(L.rms_norm(k, blk["attn_k_norm"], cfg.rms_eps), cos, sin, cfg.rope_type)
    for bb in range(b):
        n = n_past[bb]
        k_slab[bb, n:n + t] = k[bb].to(k_slab.dtype)
        v_slab[bb, n:n + t] = v[bb].to(v_slab.dtype)
    attn_fn = flash_attention_decode if t <= DECODE_MAX_T else flash_attention
    attn = attn_fn(q.to(torch.bfloat16), k_slab, v_slab, npv, npv + t,
                   scale=1.0 / float(np.sqrt(d))).float()
    if gate is not None:
        attn = attn * torch.sigmoid(gate.float())
    return blk["wo"](attn.reshape(b, t, nh * d).to(torch.bfloat16))


def _ffn(blk: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MoE (softmax top-k, normalized weights) with the sigmoid-gated shared
    expert, or the dense FFN."""
    if "experts" not in blk:
        act = L.glu(blk["ffn_gate"](h), blk["ffn_up"](h), "silu")
        return blk["ffn_down"](act.to(torch.bfloat16))
    b, t, e = h.shape
    x = h.reshape(-1, e)
    y = moe_ffn(x, blk["ffn_gate_inp"](x), blk["experts"], cfg.n_expert_used,
                norm_topk=True).reshape(b, t, e)
    if "ffn_gate_shexp" in blk:
        act = L.glu(blk["ffn_gate_shexp"](h), blk["ffn_up_shexp"](h), "silu")
        sh = blk["ffn_down_shexp"](act.to(torch.bfloat16))
        if "ffn_gate_inp_shexp" in blk:
            sh = sh * torch.sigmoid(blk["ffn_gate_inp_shexp"](h))
        y = y + sh
    return y


def _rope_tables(cfg: ModelConfig, q_pos: torch.Tensor):
    """cos/sin of the partial rope at ``q_pos`` (B, T); qwen35's imrope
    leaves the pairs of the "extra" stream unrotated, as they hold
    position 0 for text tokens."""
    rope_dims = cfg.rope_dim or cfg.head_dim
    cos, sin = L.rope_cache(q_pos, rope_dims, cfg.rope_freq_base)
    sections = (cfg.extra or {}).get("rope_sections") or []
    if sum(sections):
        m = torch.from_numpy(L.imrope_text_mask(sections, rope_dims)).to(q_pos.device)
        cos = torch.where(m, cos, torch.ones_like(cos))
        sin = torch.where(m, sin, torch.zeros_like(sin))
    return cos, sin


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, kv: HybridCache,
            n_past, *, npv: torch.Tensor | None = None, logits_last_only: bool = False,
            n_valid=None, return_hidden: bool = False,
            return_layer_hiddens: bool = False) -> torch.Tensor:
    """tokens: (B, T) on the cache's device; n_past: int or per-row list of
    ints (host); npv: the same as an int32 (B,) device tensor, made here
    when not given; n_valid: None (all T), an int, or one length a row
    (host ints) — the tokens of each row that the recurrent state takes.
    Writes the chunk into ``kv`` in place and returns the float32 logits
    (B, T or 1, V). The hidden states raise (``refuse_hidden``)."""
    refuse_hidden("Qwen3-Next", return_hidden, return_layer_hiddens)
    b, t = tokens.shape
    dev = kv.device
    n_past = [int(n_past)] * b if np.ndim(n_past) == 0 else [int(n) for n in n_past]
    if npv is None:
        npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
    if n_valid is None:
        n_valid = t
    nv = [int(n_valid)] * b if np.ndim(n_valid) == 0 else [int(n) for n in n_valid]
    if not all(0 <= n <= t for n in nv):
        raise ValueError(f"n_valid {nv} outside [0, {t}]")
    nv_t = torch.tensor(nv, dtype=torch.int32, device=dev)
    x = params["tok_embd"][tokens]                              # (B, T, E) bf16
    q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    cos, sin = _rope_tables(cfg, q_pos)
    interval = _interval(cfg)
    for i, blk in enumerate(params["blocks"]):
        h = L.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        if is_recurrent(i, interval):
            out = _delta_layer(blk, h, cfg, kv.conv[i], kv.state[i], nv_t)
        else:
            out = _gated_attention(blk, h, cfg, kv.k[i], kv.v[i], n_past, npv, cos, sin)
        x = x + out.to(x.dtype)
        x = x + _ffn(blk, L.rms_norm(x, blk["ffn_norm"], cfg.rms_eps), cfg).to(x.dtype)
    x = L.rms_norm(x, params["output_norm"], cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    return params["output"](x).float()
