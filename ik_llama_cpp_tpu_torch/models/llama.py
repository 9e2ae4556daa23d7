"""Llama, qwen3moe and qwen2moe: parameters, the KV caches and the forward
pass.

The torch counterpart of the plain-llama, qwen3moe and qwen2moe subset of
the JAX package's ``models/llama.py``: one functional forward over a
fixed-capacity KV cache of shape (L, B, S, Hkv, D). Rows are written into
the cache in place; the attention of layer i reads the slab ``kv.k[i]``,
which is a view, so the decode step never copies the capacity-sized cache
(the analogue of the JAX package's stacked-cache fast path).

The cache is bf16, or quantized on write with one of the row codecs of
``ops/kv_quant.py`` (codes plus a float32 scale per (row, kv head)), with
an optional Hadamard rotation of K (and q) and of V before the write;
``MixedKVCache`` gives the first and last layers another codec than the
bulk.

qwen3moe adds per-head RMS QK-norms before RoPE and a routed-expert FFN
(``ops/moe.py``); qwen2moe has q/k/v biases and adds a shared expert with a
sigmoid gate to the routed ones. A stacked expert tensor is re-coded per
supergroup of 256 at load where the int8 path is on and 256 divides its K,
stays planar (its format's group, bf16 scales) otherwise, and the three
become bf16 ``ExpertWeights`` when one of them has no symmetric planar form
(float tensors, asymmetric formats) or ``use_quant`` is off.

Weight names follow GGUF conventions (token_embd, blk.N.attn_q, ...).
Ring (SWA-compressed) caches, the other MoE architectures (mixtral-style
llama, deepseek2, gpt-oss, ...), MTP (other architectures),
tensor/pipeline/sequence/expert parallelism, LoRA and control vectors are
later slices of the port: asking for one raises NotImplementedError naming
the slice (here or in runtime/generate.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.flash_attention import (DECODE_MAX_T, flash_attention,
                                   flash_attention_decode,
                                   flash_attention_decode_q8,
                                   flash_attention_q8)
from ..ops.kv_quant import (KV_CODEC_DTYPE, KV_CODEC_WIDTH, KV_DECODERS,
                            KV_ENCODERS, hadamard_rotate, kv_codec_of)
from ..ops.moe import ExpertWeights, QuantExpertWeights, moe_ffn
from ..ops.qmatmul import SUPERGROUP, requant_supergroup
from ..quant.planar import PLANAR_FNS, planar_decode
from .config import ModelConfig
from .weights import (_t, dequant_tensor, fuse_linears, i8_enabled, load_dense,
                      load_linear)

ARCHS = ("llama", "qwen3moe", "qwen2moe")
MOE_ARCHS = ("qwen3moe", "qwen2moe")


def _later(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet (the {slice_} slice "
                              "of the PyTorch port)")


def _codec_name(quant) -> str:
    """True / 'q8' / 'q4' / 'q6' / 'nl4' / 'iq4_nl' -> the codec's name."""
    name = "q8" if quant is True else ("nl4" if quant == "iq4_nl" else quant)
    if name not in KV_ENCODERS:
        raise ValueError(f"unknown KV cache type {quant!r}: one of "
                         f"{sorted(KV_ENCODERS)} or 'iq4_nl'")
    return name


def _codec_stacks(codec: str, n: int, batch: int, capacity: int, hkv: int,
                  d: int, device):
    """Zeroed (k codes, v codes, k scales, v scales) of n layers."""
    qshape = (n, batch, capacity, hkv, KV_CODEC_WIDTH[codec](d))
    dt = KV_CODEC_DTYPE[codec]
    return (torch.zeros(qshape, dtype=dt, device=device),
            torch.zeros(qshape, dtype=dt, device=device),
            torch.zeros(qshape[:-1], dtype=torch.float32, device=device),
            torch.zeros(qshape[:-1], dtype=torch.float32, device=device))


@dataclass
class KVCache:
    """Fixed-capacity KV cache, k/v: (L, B, S, Hkv, D) bf16; or quantized
    on write, k/v: codes (L, B, S, Hkv, W) in the codec's dtype and stored
    width with k_scale/v_scale: float32 (L, B, S, Hkv)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, device,
               quant=False):
        """quant: False (bf16), True / 'q8' (int8 rows), 'q4' / 'q6' / 'nl4'
        ('iq4_nl') packed rows: the -ctk/-ctv q8_0 / q4_0 / q6_0 / iq4_nl
        cache types."""
        if quant:
            return cls(*_codec_stacks(_codec_name(quant), cfg.n_layer, batch,
                                      capacity, cfg.n_head_kv, cfg.head_dim,
                                      device))
        shape = (cfg.n_layer, batch, capacity, cfg.n_head_kv, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k.device


class _MixedLayerView:
    """kv.k[i]-style per-layer access over the override and bulk stacks."""

    def __init__(self, cache: "MixedKVCache", field: str):
        self._c = cache
        self._f = field

    def __getitem__(self, i: int) -> torch.Tensor:
        m = self._c.layer_map[i]
        if m >= 0:
            return getattr(self._c, self._f + "_ovr")[m]
        return getattr(self._c, self._f + "_mid")[-m - 1]


@dataclass
class MixedKVCache:
    """Per-layer KV codec overrides: the first n_first and last n_last
    layers ('ovr') use the override codec, the bulk ('mid') the base codec
    (e.g. the sensitive outer layers at q8, the rest at q4). Two stacks; a
    layer's codec is read off its slab's dtype and width, so the write and
    attention paths take no flag. Rows are written in place."""

    k_ovr: torch.Tensor
    v_ovr: torch.Tensor
    ks_ovr: torch.Tensor
    vs_ovr: torch.Tensor
    k_mid: torch.Tensor
    v_mid: torch.Tensor
    ks_mid: torch.Tensor
    vs_mid: torch.Tensor
    layer_map: tuple = ()   # m >= 0 -> ovr[m]; m < 0 -> mid[-m-1]

    @property
    def k(self):
        return _MixedLayerView(self, "k")

    @property
    def v(self):
        return _MixedLayerView(self, "v")

    @property
    def k_scale(self):
        return _MixedLayerView(self, "ks")

    @property
    def v_scale(self):
        return _MixedLayerView(self, "vs")

    @property
    def quantized(self) -> bool:
        return True

    @property
    def capacity(self) -> int:
        return self.k_mid.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k_mid.device

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, device,
               mid: str = "q4", override: str = "q8", n_first: int = 1,
               n_last: int = 1):
        lm, no, nm = [], 0, 0
        for i in range(cfg.n_layer):
            if i < n_first or i >= cfg.n_layer - n_last:
                lm.append(no)
                no += 1
            else:
                lm.append(-nm - 1)
                nm += 1
        assert no and nm, (n_first, n_last, cfg.n_layer)
        hkv, d = cfg.n_head_kv, cfg.head_dim
        return cls(*_codec_stacks(_codec_name(override), no, batch, capacity, hkv, d, device),
                   *_codec_stacks(_codec_name(mid), nm, batch, capacity, hkv, d, device),
                   tuple(lm))


def load_llama_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                      use_quant: bool = True, fuse: bool = False) -> dict:
    """GGUF -> nested dict of device tensors and linear modules.

    ``fuse`` merges q/k/v and gate/up into single matmuls at load."""
    if cfg.arch not in ARCHS:
        _later(f"architecture {cfg.arch!r}", "other-architectures")
    t = gg.tensors
    if cfg.arch not in MOE_ARCHS and any(n.endswith(".ffn_gate_inp.weight") for n in t):
        _later(f"MoE for architecture {cfg.arch!r} (mixtral-style)", "other-architectures")
    params: dict = {
        "tok_embd": torch.from_numpy(np.ascontiguousarray(
            dequant_tensor(t["token_embd.weight"]))).to(device, torch.bfloat16),
    }
    if "output_norm.weight" in t:
        params["output_norm"] = load_dense(t["output_norm.weight"], device)
    out_name = "output.weight" if "output.weight" in t else "token_embd.weight"
    params["output"] = load_linear(t[out_name], device, use_quant=use_quant)

    blocks = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        blk = {
            "attn_norm": load_dense(t[p + "attn_norm.weight"], device),
            "ffn_norm": load_dense(t[p + "ffn_norm.weight"], device),
            "wo": load_linear(t[p + "attn_output.weight"], device, use_quant=use_quant),
            "wq": load_linear(t[p + "attn_q.weight"], device, use_quant=use_quant),
            "wk": load_linear(t[p + "attn_k.weight"], device, use_quant=use_quant),
            "wv": load_linear(t[p + "attn_v.weight"], device, use_quant=use_quant),
        }
        if p + "ffn_gate_inp.weight" in t:       # routed experts
            # the router stays a bf16 dense product, as in the JAX package
            blk["ffn_gate_inp"] = load_linear(t[p + "ffn_gate_inp.weight"], device,
                                              use_quant=False)
            if p + "ffn_gate_inp.bias" in t:
                blk["ffn_gate_inp_b"] = load_dense(t[p + "ffn_gate_inp.bias"], device)
            if p + "exp_probs_b.bias" in t:      # expert selection bias
                blk["ffn_exp_probs_b"] = load_dense(t[p + "exp_probs_b.bias"], device)
            blk["experts"] = _load_experts(t, p, device, use_quant=use_quant)
            if p + "ffn_gate_shexp.weight" in t:  # shared expert (qwen2moe)
                for name in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                    blk[name] = load_linear(t[p + name + ".weight"], device,
                                            use_quant=use_quant)
                if p + "ffn_gate_inp_shexp.weight" in t:
                    blk["ffn_gate_inp_shexp"] = load_linear(
                        t[p + "ffn_gate_inp_shexp.weight"], device, use_quant=False)
        else:
            for name in ("ffn_gate", "ffn_up", "ffn_down"):
                blk[name] = load_linear(t[p + name + ".weight"], device,
                                        use_quant=use_quant)
        for opt in ("attn_q_norm", "attn_k_norm"):
            if p + opt + ".weight" in t:
                blk[opt] = load_dense(t[p + opt + ".weight"], device)
        for opt_b in ("attn_q.bias", "attn_k.bias", "attn_v.bias",
                      "attn_output.bias"):
            if p + opt_b in t:
                blk[opt_b.replace(".", "_")] = load_dense(t[p + opt_b], device)
        if fuse:
            _fuse_block(blk)
        blocks.append(blk)
    params["blocks"] = blocks
    return params


def _fuse_block(blk: dict) -> None:
    """Merge separate q/k/v (and gate/up) into fused linears in place."""
    if all(k in blk for k in ("wq", "wk", "wv")) and not any(
            k in blk for k in ("attn_q_bias", "attn_k_bias", "attn_v_bias")):
        fused = fuse_linears([blk["wq"], blk["wk"], blk["wv"]])
        if fused is not None:
            blk["wqkv"] = fused
            del blk["wq"], blk["wk"], blk["wv"]
    if "ffn_gate" in blk and "ffn_up" in blk:
        fused = fuse_linears([blk["ffn_gate"], blk["ffn_up"]])
        if fused is not None:
            blk["ffn_up"] = fused
            del blk["ffn_gate"]


def _planar_stacked(info, device):
    """A stacked expert tensor (ne = (K, N, G)) -> (codes int8 (G, K, N),
    the view of a contiguous (G, N, K) tensor; scales (G, K/group, N);
    group), or None when the format has no symmetric planar form (float
    tensors, asymmetric formats with a per-group bias). With the int8 path
    on and K a multiple of 256 the codes are re-coded per supergroup of
    256 with f32 scales, as the JAX loader does (every column on its own,
    so all experts go through one call); otherwise they stay planar with
    bf16 scales, which the kernels round to anyway."""
    k, n, g = info.shape[0], info.shape[1], info.shape[2]
    if info.ggml_type not in PLANAR_FNS:
        return None
    pw = planar_decode(info.data, info.ggml_type, k)       # rows = (expert, column)
    if pw.bias is not None:
        return None
    if i8_enabled(device) and k % SUPERGROUP == 0:
        q8, sw = requant_supergroup(pw.codes.T, pw.scale.T, group=pw.group)
        codes_t = _t(q8.T.reshape(g, n, k), device)                  # (G, N, K)
        sw = _t(sw.reshape(k // SUPERGROUP, g, n).transpose(1, 0, 2).copy(), device)
        return codes_t.transpose(1, 2), sw, SUPERGROUP
    codes_t = _t(pw.codes.reshape(g, n, k), device)
    scale = _t(pw.scale.reshape(g, n, k // pw.group).transpose(0, 2, 1), device,
               torch.bfloat16)
    return codes_t.transpose(1, 2), scale, pw.group


def _load_experts(t, prefix: str, device, *, use_quant: bool = True):
    """Stacked gate/up/down experts (ne = (K, N, G)) with their optional
    per-expert biases -> QuantExpertWeights, each projection in the form
    ``_planar_stacked`` gives it; bf16 ExpertWeights when a projection has
    no symmetric planar form or ``use_quant`` is off."""
    def bias(name):
        if prefix + name not in t:
            return None
        return _t(dequant_tensor(t[prefix + name]), device, torch.float32)

    names = ("ffn_gate_exps.weight", "ffn_up_exps.weight", "ffn_down_exps.weight")
    biases = dict(gate_b=bias("ffn_gate_exps.bias"), up_b=bias("ffn_up_exps.bias"),
                  down_b=bias("ffn_down_exps.bias"))
    if use_quant:
        planar = [_planar_stacked(t[prefix + nm], device) for nm in names]
        if all(pl is not None for pl in planar):
            (gc, gs, gg), (uc, us, ug), (dc, ds, dg) = planar
            return QuantExpertWeights(gate=gc, gate_s=gs, up=uc, up_s=us, down=dc,
                                      down_s=ds, gate_group=gg, up_group=ug,
                                      down_group=dg, **biases)

    def stacked(name):          # logical (G, N, K) -> (G, K, N) bf16
        return _t(dequant_tensor(t[prefix + name]).transpose(0, 2, 1), device,
                  torch.bfloat16)

    return ExpertWeights(gate=stacked(names[0]), up=stacked(names[1]),
                         down=stacked(names[2]), **biases)


def _act_limit(cfg: ModelConfig, il: int, shared: bool = False) -> float:
    lims = (cfg.extra or {}).get("swiglu_limits_shared" if shared else "swiglu_limits")
    return float(lims[il]) if lims else 0.0


def _ffn(blk: dict, h: torch.Tensor, cfg: ModelConfig, il: int = 0) -> torch.Tensor:
    """Dense or routed-expert feed-forward on (B, T, E) normalized input;
    a shared expert (qwen2moe), gated by a sigmoid where the model has the
    gate, adds to the routed ones."""
    if "experts" not in blk:
        return _ffn_dense(blk, h, cfg)
    b, t, e = h.shape
    x = h.reshape(-1, e)
    router = blk["ffn_gate_inp"](x)
    if "ffn_gate_inp_b" in blk:
        router = router + blk["ffn_gate_inp_b"]
    y = moe_ffn(x, router, blk["experts"], cfg.n_expert_used,
                gating=cfg.expert_gating_func,
                norm_topk=cfg.norm_topk_prob or cfg.expert_weights_norm,
                scale=cfg.expert_weights_scale,
                selection_bias=blk.get("ffn_exp_probs_b"), activation=cfg.moe_act,
                weight_before_ffn=cfg.moe_weight_before,
                act_limit=_act_limit(cfg, il)).reshape(b, t, e)
    if "ffn_gate_shexp" in blk:
        act = L.glu(blk["ffn_gate_shexp"](h), blk["ffn_up_shexp"](h), cfg.moe_act,
                    limit=_act_limit(cfg, il, shared=True))
        sh = blk["ffn_down_shexp"](act.to(torch.bfloat16))
        if "ffn_gate_inp_shexp" in blk:
            sh = sh * torch.sigmoid(blk["ffn_gate_inp_shexp"](h))
        y = y + sh
    return y


def _ffn_dense(blk: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ffn_gate" in blk:
        gate = blk["ffn_gate"](h)
        up = blk["ffn_up"](h)
    else:  # fused gate+up in one matmul
        gate, up = torch.chunk(blk["ffn_up"](h), 2, dim=-1)
    act = L.glu(gate, up, cfg.act).to(torch.bfloat16)
    return blk["ffn_down"](act)


def _attn_block(blk: dict, x: torch.Tensor, cfg: ModelConfig, kv,
                il: int, n_past: list[int], npv: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One attention sublayer over (B, T, E). Writes this chunk's K/V rows
    into layer ``il`` of the cache in place (quantized with the layer's
    codec when the cache is), then attends over that layer's slab: a decode
    kernel for T <= 16, a prefill kernel otherwise."""
    b, t, _ = x.shape
    h, hkv, d = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    if "wqkv" in blk:
        qkv = blk["wqkv"](x)
        q = qkv[..., : h * d]
        k = qkv[..., h * d: h * d + hkv * d]
        v = qkv[..., h * d + hkv * d:]
    else:
        q, k, v = blk["wq"](x), blk["wk"](x), blk["wv"](x)
    if "attn_q_bias" in blk:
        q = q + blk["attn_q_bias"]
    if "attn_k_bias" in blk:
        k = k + blk["attn_k_bias"]
    if "attn_v_bias" in blk:
        v = v + blk["attn_v_bias"]
    q, k = q.reshape(b, t, h, d), k.reshape(b, t, hkv, d)
    if "attn_q_norm" in blk:                   # qwen3: per-head RMS norm
        q = L.rms_norm(q, blk["attn_q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, blk["attn_k_norm"], cfg.rms_eps)
    q = L.apply_rope(q, cos, sin, cfg.rope_type)
    k = L.apply_rope(k, cos, sin, cfg.rope_type)
    v = v.reshape(b, t, hkv, d)
    # -khad / -vhad: rotate K and q (scores unchanged) and/or V by a head-dim
    # Hadamard before the cache write; V is un-rotated after attention
    if cfg.k_hadamard:
        k, q = hadamard_rotate(k), hadamard_rotate(q)
    if cfg.v_hadamard:
        v = hadamard_rotate(v)

    k_slab, v_slab = kv.k[il], kv.v[il]          # views (B, S, Hkv, W)
    kw = dict(scale=cfg.f_attention_scale or (1.0 / float(np.sqrt(d))),
              softcap=cfg.attn_softcap, swa_window=cfg.swa_window,
              attn_chunk=cfg.attn_chunk)
    qb = q.to(torch.bfloat16)
    if not kv.quantized:
        for bb in range(b):
            n = n_past[bb]
            k_slab[bb, n:n + t] = k[bb].to(k_slab.dtype)
            v_slab[bb, n:n + t] = v[bb].to(v_slab.dtype)
        attn_fn = flash_attention_decode if t <= DECODE_MAX_T else flash_attention
        attn = attn_fn(qb, k_slab, v_slab, npv, npv + t, **kw)
    else:
        ks_slab, vs_slab = kv.k_scale[il], kv.v_scale[il]     # (B, S, Hkv)
        codec = kv_codec_of(k_slab, d)
        kq, ks = KV_ENCODERS[codec](k)            # quantize on write
        vq, vs = KV_ENCODERS[codec](v)
        for bb in range(b):
            n = n_past[bb]
            k_slab[bb, n:n + t], ks_slab[bb, n:n + t] = kq[bb], ks[bb]
            v_slab[bb, n:n + t], vs_slab[bb, n:n + t] = vq[bb], vs[bb]
        if t <= DECODE_MAX_T:
            attn = flash_attention_decode_q8(qb, k_slab, ks_slab, v_slab, vs_slab,
                                             npv, npv + t, **kw)
        elif codec == "q8":
            attn = flash_attention_q8(qb, k_slab, ks_slab, v_slab, vs_slab,
                                      npv, npv + t, **kw)
        else:
            # the packed codecs have no fused prefill kernel: the filled
            # rows are decoded to bf16 for the bf16 prefill kernel
            fill = max(n_past) + t
            dec = KV_DECODERS[codec]
            attn = flash_attention(
                qb, dec(k_slab[:, :fill], ks_slab[:, :fill]).to(torch.bfloat16),
                dec(v_slab[:, :fill], vs_slab[:, :fill]).to(torch.bfloat16),
                npv, npv + t, **kw)
    if cfg.v_hadamard:
        attn = hadamard_rotate(attn)   # attn = A @ (V H), so attn @ H = A @ V
    out = blk["wo"](attn.reshape(b, t, h * d))
    if "attn_output_bias" in blk:
        out = out + blk["attn_output_bias"]
    return out


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.n_head_arr or cfg.n_head_kv_arr or cfg.n_ff_arr:
        _later("per-layer head/FFN widths", "other-architectures")
    if cfg.alibi_max_bias > 0 or not cfg.use_rope or cfg.parallel_residual:
        _later(f"the {cfg.arch} graph variant", "other-architectures")


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, kv,
            n_past, *, npv: torch.Tensor | None = None,
            logits_last_only: bool = False) -> torch.Tensor:
    """tokens: (B, T) on the cache's device; n_past: int or per-row list of
    ints (host); npv: the same as an int32 (B,) device tensor, made here
    when not given. Writes the chunk into ``kv`` in place and returns the
    float32 logits (B, T or 1, V)."""
    _check_cfg(cfg)
    if "cvec" in params:
        _later("control vectors", "LoRA")
    b, t = tokens.shape
    dev = kv.device
    n_past = [int(n_past)] * b if np.ndim(n_past) == 0 else [int(n) for n in n_past]
    if npv is None:
        npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
    x = params["tok_embd"][tokens]                      # (B, T, E) bf16
    q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    freq_scale = (1.0 / cfg.rope_scale_factor
                  if cfg.rope_scaling in ("linear", "yarn")
                  and cfg.rope_scale_factor not in (0.0, 1.0) else 1.0)
    ext_factor = 1.0 if (cfg.rope_scaling == "yarn" and freq_scale != 1.0) else 0.0
    cos, sin = L.rope_cache(q_pos, cfg.rope_dim or cfg.head_dim,
                            cfg.rope_freq_base, freq_scale,
                            ext_factor=ext_factor,
                            attn_factor=cfg.rope_attn_factor or 1.0,
                            n_ctx_orig=cfg.rope_orig_ctx or cfg.n_ctx_train)
    for i, blk in enumerate(params["blocks"]):
        h = L.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        attn_out = _attn_block(blk, h, cfg, kv, i, n_past, npv, cos, sin)
        x = x + attn_out.to(x.dtype)
        h = L.rms_norm(x, blk["ffn_norm"], cfg.rms_eps)
        x = x + _ffn(blk, h, cfg, i).to(x.dtype)
    x = L.rms_norm(x, params.get("output_norm"), cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    logits = params["output"](x).float()
    if cfg.f_logit_scale > 0:
        logits = (logits * cfg.f_logit_scale if cfg.logit_scale_mul
                  else logits / cfg.f_logit_scale)
    if cfg.final_softcap > 0:
        logits = L.softcap(logits, cfg.final_softcap)
    return logits
