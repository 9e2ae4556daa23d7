"""The DeepSeek-2 family (deepseek2, mistral4, glm-dsa): MLA attention and
MoE FFNs with shared experts, on a latent or a per-head KV cache.

The torch counterpart of the JAX package's ``models/deepseek2.py``, function
by function (build_deepseek2 of the reference):
  * q = q_b(rms(q_a(x))) (or wq for the "lite" models), cut per head into
    (nope | rope); kv_a_mqa(x) gives the latent and one shared roped k_pe
  * YaRN pre-scaling: kq_scale = mscale^2 / sqrt(Dk) and the rope's
    attention factor 1 / (1 + 0.1 ln(1 / freq_scale))
  * the first n_layer_dense_lead layers a dense FFN, the rest MoE with
    softmax or sigmoid gating, an optional selection bias (exp_probs_b),
    normalized top-k weights, a routed scale, and shared experts
  * glm-dsa: the lightning indexer picks each query's top-k keys
    (``_dsa_topk_mask``), and attention runs under that allow mask

``mla=True`` (what ``Runtime.from_gguf`` loads) is the latent-cache absorb
path: the cache holds [latent | roped k_pe] (576 values a token for
DeepSeek-V2-Lite) in one kv head, q's nope part is absorbed through wk_b so
scores form against the latents, and the weighted latents are re-projected
through wv_b. Its attention is the MLA form of the prefill kernel
(``ops/flash_attention.flash_attention``, ``csrc/flash_attention_mla.cu``)
at every T, as the JAX package calls its Pallas kernel at every T there.
``mla=False`` keeps per-head K/V in the cache (kernel B at Dk 192 / Dv
128). The absorb products q_nope @ wk_b and attn @ wv_b are plain float32
products, einsums outside Pallas in the JAX package too.

Rows are written into the cache in place, as ``models/llama.py`` writes
them. The latent cache of a model without an indexer has no second tensor
(``KVCache.v`` is None), where the JAX package keeps a (L, 1, 1, 1, 1)
placeholder: a cache row view (``server/engine.cache_rows``) then has
nothing to narrow but the latents. With an indexer, ``v`` holds the
indexer's key cache (L, B, S, 1, head size).
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.attention import attend
from ..ops.flash_attention import flash_attention
from ..ops.moe import moe_ffn
from .config import ModelConfig
from .llama import _EXPERT_TENSORS, KVCache, _later, _load_experts, refuse_hidden
from .weights import DenseLinear, _t, dequant_tensor, load_dense, load_linear

ARCHS = ("deepseek2", "mistral4", "glm-dsa")

# forward() arguments of the JAX package that later slices bring
_LATER_ARGS = {"collect_stats": "device tools (item 9)", "tp_axis": "multi-GPU (item 11)"}


def load_deepseek2_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                          use_quant: bool = True, mla: bool = True) -> dict:
    """GGUF -> nested dict of device tensors and linear modules.

    ``mla=True``: the absorb projections wk_b (H, nope, lora_kv) and wv_b
    (H, lora_kv, dv) in bf16, cut at load from attn_kv_b (llm_prepare_mla),
    or from glm-dsa's pre-split attn_k_b / attn_v_b. ``mla=False``: the
    fused attn_kv_b linear; from glm-dsa's pre-split pair it is rebuilt as
    a bf16 ``DenseLinear``. The indexer's linears stay unquantized: its
    top-k is a discrete choice that int8 weight noise would move. Every
    ``blk.N.*`` tensor is consumed or refused."""
    t = gg.tensors
    used: set = set()

    def take(name: str):
        used.add(name)
        return t[name]

    def linear(name: str, quant: bool = use_quant):
        return load_linear(take(name), device, use_quant=quant)

    def dense(name: str):
        return load_dense(take(name), device)

    def bf16(a) -> torch.Tensor:
        return _t(np.ascontiguousarray(a), device, torch.bfloat16)

    params: dict = {"tok_embd": bf16(dequant_tensor(take("token_embd.weight"))),
                    "output_norm": dense("output_norm.weight")}
    params["output"] = linear("output.weight" if "output.weight" in t
                              else "token_embd.weight")
    h, lora_kv = cfg.n_head, cfg.n_lora_kv
    d_nope, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    blocks = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        blk = {"attn_norm": dense(p + "attn_norm.weight"),
               "wkv_a_mqa": linear(p + "attn_kv_a_mqa.weight"),
               "kv_a_norm": dense(p + "attn_kv_a_norm.weight"),
               "wo": linear(p + "attn_output.weight"),
               "ffn_norm": dense(p + "ffn_norm.weight")}
        if p + "attn_k_b.weight" in t:
            # glm-dsa's pre-split pair: attn_k_b ne {nope, lora_kv, h},
            # attn_v_b ne {lora_kv, dv, h}
            # (a fused attn_kv_b beside them holds the same weights: unread,
            # as in the JAX loader)
            used.add(p + "attn_kv_b.weight")
            kb = dequant_tensor(take(p + "attn_k_b.weight")).reshape(h, lora_kv, d_nope)
            vb = dequant_tensor(take(p + "attn_v_b.weight")).reshape(h, dv, lora_kv)
            blk["wk_b"] = bf16(kb.transpose(0, 2, 1))
            blk["wv_b"] = bf16(vb.transpose(0, 2, 1))
            if not mla:
                # the fused wkv_b of the full-KV path, (lora_kv, h (nope + dv))
                kv_w = np.concatenate([kb.transpose(0, 2, 1), vb], axis=1)
                blk["wkv_b"] = DenseLinear(bf16(kv_w.reshape(h * (d_nope + dv), lora_kv).T))
        elif mla:
            kvb = dequant_tensor(take(p + "attn_kv_b.weight")).reshape(h, d_nope + dv, lora_kv)
            blk["wk_b"] = bf16(kvb[:, :d_nope, :])
            blk["wv_b"] = bf16(kvb[:, d_nope:, :].transpose(0, 2, 1))
        else:
            blk["wkv_b"] = linear(p + "attn_kv_b.weight")
        if p + "attn_q_a.weight" in t:            # q-lora
            blk["wq_a"] = linear(p + "attn_q_a.weight")
            blk["q_a_norm"] = dense(p + "attn_q_a_norm.weight")
            blk["wq_b"] = linear(p + "attn_q_b.weight")
        else:                                     # lite
            blk["wq"] = linear(p + "attn_q.weight")
        if p + "indexer.attn_q_b.weight" in t:   # the DSA lightning indexer
            blk["idx_q_b"] = linear(p + "indexer.attn_q_b.weight", False)
            blk["idx_k"] = linear(p + "indexer.attn_k.weight", False)
            blk["idx_k_norm"] = dense(p + "indexer.k_norm.weight")
            blk["idx_k_norm_b"] = dense(p + "indexer.k_norm.bias")
            blk["idx_proj"] = linear(p + "indexer.proj.weight", False)
        if p + "ffn_gate_inp.weight" in t:
            # the router stays a bf16 dense product, as in the JAX package
            blk["ffn_gate_inp"] = linear(p + "ffn_gate_inp.weight", False)
            used.update(p + nm for nm in _EXPERT_TENSORS if p + nm in t)
            blk["experts"] = _load_experts(t, p, device, use_quant=use_quant)
            if p + "exp_probs_b.bias" in t:
                blk["exp_probs_b"] = dense(p + "exp_probs_b.bias")
            if p + "ffn_gate_shexp.weight" in t:
                for name in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                    blk[name] = linear(p + name + ".weight")
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


def _write_rows(slab: torch.Tensor, rows: torch.Tensor, n_past: list) -> None:
    """rows (B, T, ...) into slab (B, S, ...) at each batch row's n_past,
    in place."""
    t = rows.shape[1]
    for bb, n in enumerate(n_past):
        slab[bb, n:n + t] = rows[bb].to(slab.dtype)


def _queries(blk: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (B, T, H, Dk) from the q-lora pair or the lite model's wq."""
    b, t, _ = x.shape
    if "wq_a" in blk:
        q = blk["wq_b"](L.rms_norm(blk["wq_a"](x), blk["q_a_norm"], cfg.rms_eps))
    else:
        q = blk["wq"](x)
    return q.reshape(b, t, cfg.n_head, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _top_k_lowest_first(score: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each row of ``score``,
    ties broken toward the lower index, as ``jax.lax.top_k`` breaks them: a
    stable descending sort keeps equal entries in index order. Many of
    the indexer's scores tie exactly (a sum of relus that are all 0, the
    masked -inf), so ``torch.topk``, whose order among ties is unspecified,
    could pick other keys than the JAX package."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def _dsa_topk_mask(blk: dict, hcur: torch.Tensor, q_latent: torch.Tensor,
                   cfg: ModelConfig, kr_cache: torch.Tensor, n_past: list,
                   npv: torch.Tensor, q_pos: torch.Tensor, cos, sin) -> torch.Tensor:
    """The lightning indexer's key selection (build_deepseek2_dsa_indexer).
    Writes this chunk's indexer keys into kr_cache (B, S, 1, HS) in place
    and returns the allow mask (B, T, S) bool: score[j, i] = sum_h w[h, j]
    relu(iq[h, j] . kr[i]) under the causal mask, each sequence's first key
    boosted by 1e20 so that it always survives, then each query's top-k
    keys (ties toward the lower key, ``_top_k_lowest_first``)."""
    ex = cfg.extra or {}
    b, t, _ = hcur.shape
    nh, hs = int(ex["indexer_n_head"]), int(ex["indexer_head_size"])
    top_k = int(ex.get("dsa_top_k", 0)) or int(ex["indexer_top_k"])
    d_rope = cfg.qk_rope_head_dim

    iq = blk["idx_q_b"](q_latent).reshape(b, t, nh, hs)
    iq = torch.cat([L.apply_rope(iq[..., :d_rope], cos, sin, cfg.rope_type),
                    iq[..., d_rope:]], dim=-1)
    ik = L.layer_norm(blk["idx_k"](hcur), blk["idx_k_norm"], blk["idx_k_norm_b"],
                      cfg.rms_eps).reshape(b, t, 1, hs)
    ik = torch.cat([L.apply_rope(ik[..., :d_rope], cos, sin, cfg.rope_type),
                    ik[..., d_rope:]], dim=-1)
    _write_rows(kr_cache, ik, n_past)

    w = blk["idx_proj"](hcur).float() / math.sqrt(float(hs * nh))      # (B, T, nh)
    kr = kr_cache[:, :, 0, :].float()                                   # (B, S, HS)
    kq = torch.einsum("bthd,bsd->bhts", iq.float(), kr)
    score = torch.einsum("bth,bhts->bts", w, torch.relu(kq))

    s_cap = kr_cache.shape[1]
    key_pos = torch.arange(s_cap, dtype=torch.int32, device=hcur.device)[None, None, :]
    kv_len = npv + t
    causal = (key_pos <= q_pos[:, :, None]) & (key_pos < kv_len[:, None, None])
    score = torch.where(causal, score, torch.full_like(score, -math.inf))
    score = score + torch.where(key_pos == 0, 1e20, 0.0)
    idx = _top_k_lowest_first(score, min(top_k, s_cap))
    allow = torch.zeros((b, t, s_cap), dtype=torch.bool, device=hcur.device)
    allow.scatter_(-1, idx, True)
    return allow & causal


def _mla_absorb_attention(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                          kv_lat: torch.Tensor, n_past: list, npv: torch.Tensor,
                          q_pos: torch.Tensor, cos, sin, kq_scale: float,
                          allow_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Latent-cache attention: cache rows [latent (lora_kv) | roped k_pe]
    shared by every head (one kv head); q's nope part absorbed through wk_b
    so that scores form against the latents, which are also the values,
    re-projected per head through wv_b. Writes the chunk's rows into the
    layer slab kv_lat (B, S, 1, lora_kv + rope) in place."""
    b, t, _ = x.shape
    h, d_nope, lora_kv = cfg.n_head, cfg.qk_nope_head_dim, cfg.n_lora_kv
    q = _queries(blk, x, cfg)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]
    q_pe = L.apply_rope(q_pe, cos, sin, cfg.rope_type)

    kv_c = blk["wkv_a_mqa"](x)
    latent = L.rms_norm(kv_c[..., :lora_kv], blk["kv_a_norm"], cfg.rms_eps)
    k_pe = L.apply_rope(kv_c[..., lora_kv:].reshape(b, t, 1, -1), cos, sin, cfg.rope_type)

    # absorb: q_lat[h] = q_nope[h] @ wk_b[h]  (nope -> lora_kv)
    q_lat = torch.einsum("bthd,hdl->bthl", q_nope.float(), blk["wk_b"].float())
    q_full = torch.cat([q_lat, q_pe.float()], dim=-1)
    row = torch.cat([latent, k_pe[:, :, 0, :]], dim=-1).reshape(b, t, 1, -1)
    _write_rows(kv_lat, row, n_past)

    kv_len = npv + t
    v_view = kv_lat[..., :lora_kv]              # the values are the latents
    qb = q_full.to(torch.bfloat16)
    if allow_mask is not None:                  # DSA: plain attention under the mask
        attn = attend(qb, kv_lat, v_view, q_pos=q_pos, kv_len=kv_len, scale=kq_scale,
                      allow_mask=allow_mask)
    else:
        attn = flash_attention(qb, kv_lat, v_view, npv, kv_len, scale=kq_scale)
    out = torch.einsum("bthl,hlv->bthv", attn.float(), blk["wv_b"].float())
    return blk["wo"](out.to(torch.bfloat16).reshape(b, t, h * cfg.v_head_dim))


def _mla_attention(blk: dict, x: torch.Tensor, cfg: ModelConfig, kv_k: torch.Tensor,
                   kv_v: torch.Tensor, n_past: list, npv: torch.Tensor, q_pos: torch.Tensor,
                   cos, sin, kq_scale: float) -> torch.Tensor:
    """The full-KV path: per-head K = [k_nope from wkv_b | the shared roped
    k_pe] and V from wkv_b, written into the layer slabs kv_k (B, S, H, Dk)
    and kv_v (B, S, H, Dv) in place."""
    b, t, _ = x.shape
    h, d_nope, lora_kv = cfg.n_head, cfg.qk_nope_head_dim, cfg.n_lora_kv
    d_rope, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
    q = _queries(blk, x, cfg)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]
    kv_c = blk["wkv_a_mqa"](x)
    latent = kv_c[..., :lora_kv]
    k_pe = kv_c[..., lora_kv:].reshape(b, t, 1, d_rope)
    q_pe = L.apply_rope(q_pe, cos, sin, cfg.rope_type)
    k_pe = L.apply_rope(k_pe, cos, sin, cfg.rope_type)
    latent = L.rms_norm(latent, blk["kv_a_norm"], cfg.rms_eps)
    kvb = blk["wkv_b"](latent).reshape(b, t, h, d_nope + dv)
    k_nope, v = kvb[..., :d_nope], kvb[..., d_nope:]
    k = torch.cat([k_nope, k_pe.expand(b, t, h, d_rope)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    _write_rows(kv_k, k, n_past)
    _write_rows(kv_v, v, n_past)
    attn = flash_attention(q.to(torch.bfloat16), kv_k, kv_v, npv, npv + t, scale=kq_scale)
    return blk["wo"](attn.reshape(b, t, h * dv))


def _ds_ffn(blk: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense lead's FFN, or routed experts plus the shared experts."""
    b, t, e = h.shape
    if "experts" not in blk:
        act = L.swiglu(blk["ffn_gate"](h), blk["ffn_up"](h))
        return blk["ffn_down"](act.to(torch.bfloat16))
    x = h.reshape(-1, e)
    y = moe_ffn(x, blk["ffn_gate_inp"](x), blk["experts"], cfg.n_expert_used,
                gating=cfg.expert_gating_func, norm_topk=cfg.expert_weights_norm,
                scale=cfg.expert_weights_scale,
                selection_bias=blk.get("exp_probs_b")).reshape(b, t, e)
    if "ffn_gate_shexp" in blk:
        act = L.swiglu(blk["ffn_gate_shexp"](h), blk["ffn_up_shexp"](h))
        y = y + blk["ffn_down_shexp"](act.to(torch.bfloat16))
    return y


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, kv: KVCache,
            n_past, *, npv: torch.Tensor | None = None,
            logits_last_only: bool = False, return_hidden: bool = False,
            return_layer_hiddens: bool = False, **later) -> torch.Tensor:
    """tokens: (B, T) on the cache's device; n_past: int or per-row list of
    ints (host); npv: the same as an int32 (B,) device tensor, made here
    when not given. Writes the chunk into ``kv`` in place and returns the
    float32 logits (B, T or 1, V). ``collect_stats`` and ``tp_axis`` raise
    NotImplementedError naming the slice that brings them; so do the hidden
    states (``refuse_hidden``)."""
    refuse_hidden("DeepSeek-2", return_hidden, return_layer_hiddens)
    for name in later:
        if name not in _LATER_ARGS:
            raise TypeError(f"forward() got an unexpected keyword argument {name!r}")
        _later(f"forward's {name!r}", _LATER_ARGS[name])
    b, t = tokens.shape
    dev = kv.device
    n_past = [int(n_past)] * b if np.ndim(n_past) == 0 else [int(n) for n in n_past]
    if npv is None:
        npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
    x = params["tok_embd"][tokens]
    q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]

    # the YaRN pre-scaling of build_deepseek2 (llama.cpp #7416)
    freq_scale = 1.0 / cfg.rope_scale_factor if cfg.rope_scale_factor else 1.0
    yarn = cfg.rope_scaling == "yarn" and freq_scale != 1.0
    mscale = attn_factor_scaled = 1.0
    if yarn:
        mscale = cfg.rope_attn_factor * (1.0 + cfg.rope_yarn_log_mul
                                         * math.log(1.0 / freq_scale))
        attn_factor_scaled = 1.0 / (1.0 + 0.1 * math.log(1.0 / freq_scale))
    kq_scale = mscale * mscale / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    cos, sin = L.rope_cache(
        q_pos, cfg.qk_rope_head_dim, cfg.rope_freq_base, freq_scale,
        ext_factor=1.0 if yarn else 0.0,
        attn_factor=attn_factor_scaled * cfg.rope_attn_factor if yarn else 1.0,
        n_ctx_orig=cfg.rope_orig_ctx or cfg.n_ctx_train)

    absorb = "wk_b" in params["blocks"][0]
    # DSA sparse attention: layers with their own indexer select keys, the
    # others (IndexShare) reuse the last selecting layer's mask
    dsa_on = (absorb and (cfg.extra or {}).get("dsa_enabled", True)
              and any("idx_q_b" in blk for blk in params["blocks"]))
    last_allow = None
    for i, blk in enumerate(params["blocks"]):
        hcur = L.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        if absorb:
            allow = None
            if dsa_on:
                if "idx_q_b" in blk:
                    q_lat = L.rms_norm(blk["wq_a"](hcur), blk["q_a_norm"], cfg.rms_eps)
                    allow = last_allow = _dsa_topk_mask(blk, hcur, q_lat, cfg, kv.v[i],
                                                        n_past, npv, q_pos, cos, sin)
                else:
                    allow = last_allow
            attn_out = _mla_absorb_attention(blk, hcur, cfg, kv.k[i], n_past, npv, q_pos,
                                             cos, sin, kq_scale, allow_mask=allow)
        else:
            attn_out = _mla_attention(blk, hcur, cfg, kv.k[i], kv.v[i], n_past, npv, q_pos,
                                      cos, sin, kq_scale)
        x = x + attn_out.to(x.dtype)
        ff = _ds_ffn(blk, L.rms_norm(x, blk["ffn_norm"], cfg.rms_eps), cfg)
        x = x + ff.to(x.dtype)
    x = L.rms_norm(x, params["output_norm"], cfg.rms_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    return params["output"](x).float()


def make_cache(cfg: ModelConfig, batch: int, capacity: int, device, *,
               mla: bool = True, quant=False) -> KVCache:
    """The latent cache (``mla``): k (L, B, S, 1, lora_kv + rope), and v
    the indexer's key cache (L, B, S, 1, head size) for a DSA model, else
    None. Otherwise per-head k (L, B, S, H, Dk) and v (L, B, S, H, Dv). The
    cache is bf16: ``quant`` has no effect on this family, as in the JAX
    package, and is logged."""
    if quant:
        logging.getLogger("ik_llama_cpp_tpu_torch").warning(
            "KV cache type %r has no effect on %s: its cache is bf16", quant, cfg.arch)
    bf16 = torch.bfloat16
    if mla:
        k = torch.zeros((cfg.n_layer, batch, capacity, 1,
                         cfg.n_lora_kv + cfg.qk_rope_head_dim), dtype=bf16, device=device)
        hs = int((cfg.extra or {}).get("indexer_head_size", 0))
        v = (torch.zeros((cfg.n_layer, batch, capacity, 1, hs), dtype=bf16, device=device)
             if hs else None)
        return KVCache(k, v)
    dk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return KVCache(
        torch.zeros((cfg.n_layer, batch, capacity, cfg.n_head, dk), dtype=bf16, device=device),
        torch.zeros((cfg.n_layer, batch, capacity, cfg.n_head, cfg.v_head_dim), dtype=bf16,
                    device=device))
