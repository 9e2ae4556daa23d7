"""Dense llama: parameters, bf16 KV cache and the forward pass.

The torch counterpart of the plain-llama subset of the JAX package's
``models/llama.py``: one functional forward over a fixed-capacity KV cache
of shape (L, B, S, Hkv, D). Rows are written into the cache in place; the
attention of layer i reads the slab ``kv.k[i]``, which is a view, so the
decode step never copies the capacity-sized cache (the analogue of the JAX
package's stacked-cache fast path).

Weight names follow GGUF conventions (token_embd, blk.N.attn_q, ...).
Quantized KV, ring (SWA-compressed) caches, MoE, MTP (other
architectures), tensor/pipeline/sequence parallelism, LoRA and control
vectors are later slices of the port: asking for one raises
NotImplementedError naming the slice (here or in runtime/generate.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.flash_attention import (DECODE_MAX_T, flash_attention,
                                   flash_attention_decode)
from .config import ModelConfig
from .weights import dequant_tensor, fuse_linears, load_dense, load_linear


def _later(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet (the {slice_} slice "
                              "of the PyTorch port)")


@dataclass
class KVCache:
    """Fixed-capacity bf16 KV cache, k/v: (L, B, S, Hkv, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, device,
               quant=False):
        if quant:
            _later("quantized KV cache", "quantized-KV")
        shape = (cfg.n_layer, batch, capacity, cfg.n_head_kv, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def load_llama_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                      use_quant: bool = True, fuse: bool = False) -> dict:
    """GGUF -> nested dict of device tensors and linear modules.

    ``fuse`` merges q/k/v and gate/up into single matmuls at load."""
    if cfg.arch != "llama":
        _later(f"architecture {cfg.arch!r}", "other-architectures")
    t = gg.tensors
    if any(name.endswith(".ffn_gate_inp.weight") for name in t):
        _later("MoE (mixtral-style llama)", "MoE")
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
            "ffn_gate": load_linear(t[p + "ffn_gate.weight"], device, use_quant=use_quant),
            "ffn_up": load_linear(t[p + "ffn_up.weight"], device, use_quant=use_quant),
            "ffn_down": load_linear(t[p + "ffn_down.weight"], device, use_quant=use_quant),
        }
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


def _ffn_dense(blk: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ffn_gate" in blk:
        gate = blk["ffn_gate"](h)
        up = blk["ffn_up"](h)
    else:  # fused gate+up in one matmul
        gate, up = torch.chunk(blk["ffn_up"](h), 2, dim=-1)
    act = L.glu(gate, up, cfg.act).to(torch.bfloat16)
    return blk["ffn_down"](act)


def _attn_block(blk: dict, x: torch.Tensor, cfg: ModelConfig, kv: KVCache,
                il: int, n_past: list[int], npv: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One attention sublayer over (B, T, E). Writes this chunk's K/V rows
    into layer ``il`` of the cache in place, then attends over that layer's
    slab: the decode kernel for T <= 16, the prefill kernel otherwise."""
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
    q = L.apply_rope(q.reshape(b, t, h, d), cos, sin, cfg.rope_type)
    k = L.apply_rope(k.reshape(b, t, hkv, d), cos, sin, cfg.rope_type)
    v = v.reshape(b, t, hkv, d)

    k_slab, v_slab = kv.k[il], kv.v[il]          # views (B, S, Hkv, D)
    for bb in range(b):
        n = n_past[bb]
        k_slab[bb, n:n + t] = k[bb].to(k_slab.dtype)
        v_slab[bb, n:n + t] = v[bb].to(v_slab.dtype)

    attn_fn = flash_attention_decode if t <= DECODE_MAX_T else flash_attention
    attn = attn_fn(q.to(torch.bfloat16), k_slab, v_slab, npv, npv + t,
                   scale=cfg.f_attention_scale or (1.0 / float(np.sqrt(d))),
                   softcap=cfg.attn_softcap, swa_window=cfg.swa_window,
                   attn_chunk=cfg.attn_chunk)
    out = blk["wo"](attn.reshape(b, t, h * d))
    if "attn_output_bias" in blk:
        out = out + blk["attn_output_bias"]
    return out


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.n_head_arr or cfg.n_head_kv_arr or cfg.n_ff_arr:
        _later("per-layer head/FFN widths", "other-architectures")
    if cfg.alibi_max_bias > 0 or not cfg.use_rope or cfg.parallel_residual:
        _later(f"the {cfg.arch} graph variant", "other-architectures")


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
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
    dev = kv.k.device
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
        x = x + _ffn_dense(blk, h, cfg).to(x.dtype)
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
