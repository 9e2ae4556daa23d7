"""The dense transformer family on one graph: parameters, the KV caches and
the forward pass.

The torch counterpart of the JAX package's ``models/llama.py``: one
functional forward over a fixed-capacity KV cache of shape (L, B, S, Hkv,
D) that runs every architecture of ``ARCHS``, the JAX runtime's dense
family (llama, qwen2/3, mistral, gemma/2/3, phi3, the qwen and mixtral-style
MoE models, gpt-oss, command-r, granite, the classic gpt2 / falcon / bloom /
mpt families, llama4, step35, deci, bitnet, ...). What tells them apart is
configuration (``models/config.py``) and the tensors the file carries:
LayerNorm or RMS norms, fused or separate q/k/v, parallel residuals, ALiBi,
NoPE layers, per-layer head counts and FFN widths, attention sinks and
gates, sandwich and sub-norms, dense FFNs beside experts. Rows are written
into the cache in place; the attention of layer i reads the slab
``kv.k[i]``, which is a view, so the decode step never copies the
capacity-sized cache (the analogue of the JAX package's stacked-cache fast
path).

The cache is bf16, or quantized on write with one of the row codecs of
``ops/kv_quant.py`` (codes plus a float32 scale per (row, kv head)), with
an optional Hadamard rotation of K (and q) and of V before the write;
``MixedKVCache`` gives the first and last layers another codec than the
bulk; ``SwaKVCache`` (--swa-compress) keeps the sliding-window layers in a
ring of about window + margin rows.

A stacked expert tensor is re-coded per supergroup of 256 at load where the
int8 path is on and 256 divides its K, stays planar (its format's group,
bf16 scales) otherwise, and the three become bf16 ``ExpertWeights`` when
one of them has no symmetric planar form (float tensors, asymmetric
formats) or ``use_quant`` is off. Control vectors (``params["cvec"]``,
``runtime/cvector.py``) add to each layer's output. A trailing NextN/MTP
block (``params["mtp_blocks"]``) runs in ``mtp_forward``, which drafts
from the forward's pre-output-norm stream (``return_mtp_hidden``).

The forward also takes embeddings in place of token ids
(``inputs_embeds``), explicit positions with an in-block visibility mask
(``positions`` / ``block_mask``: the lookahead probe, on the plain
``attend`` as the JAX package runs it on XLA), the live length of a padded
chunk (``n_valid``: a ring layer drops the padded rows' writes) and every
layer's output (``return_layer_hiddens``).

Weight names follow GGUF conventions (token_embd, blk.N.attn_q, ...).
Later slices of the port, each raising NotImplementedError that names its
queue item in ROADMAP.md §1: the architectures with a forward of their
own that are not ported yet (deepseek4, gemma4, openpangu, t5, dflash;
item 8; the DeepSeek-2 family runs ``models/deepseek2.py``, the Qwen3-Next
family ``models/qwen3next.py``, mamba ``models/mamba.py`` and the BERT
family ``models/bert.py``), the activation statistics (item 9) and tensor
/ pipeline / sequence / expert parallelism (item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.attention import alibi_slopes, attend
from ..ops.flash_attention import (DECODE_MAX_T, flash_attention,
                                   flash_attention_decode,
                                   flash_attention_decode_q8,
                                   flash_attention_q8)
from ..ops.kv_quant import (KV_CODEC_DTYPE, KV_CODEC_WIDTH, KV_DECODERS,
                            KV_ENCODERS, hadamard_rotate, kv_codec_of)
from ..ops.moe import ExpertWeights, QuantExpertWeights, moe_ffn
from ..ops.qmatmul import SUPERGROUP, requant_rows
from ..quant.planar import PLANAR_FNS, planar_decode
from .config import ModelConfig
from .weights import (_t, dequant_tensor, fuse_linears, i8_enabled, load_dense,
                      load_linear, scale_linear)

# the JAX runtime's dense family: every architecture that runs this forward
ARCHS = ("llama", "llama4", "granitemoe", "qwen2vl", "step35",
         "qwen3vl", "qwen3vlmoe",
         "qwen2", "qwen3", "mistral", "gemma",
         "gemma2", "gemma3", "phi3", "qwen2moe", "qwen3moe",
         "internlm2", "smollm3", "mistral3", "granite",
         "exaone", "starcoder2", "mixtral", "gpt-oss",
         "command-r", "cohere2",
         # classic families on the same configurable graph
         "gpt2", "gptneox", "falcon", "mpt", "bloom", "starcoder",
         "refact", "phi2", "stablelm", "jais", "olmo", "baichuan",
         "orion", "xverse", "minicpm", "qwen", "codeshell",
         "chatglm", "glm4", "glm4moe",
         # modern MoE / scaled variants on the same graph
         "seed_oss", "mellum", "hunyuan-moe", "dots1", "ernie4_5",
         "ernie4_5-moe", "minimax-m2", "minimax-m3", "mimo2",
         "cohere2_moe", "laguna", "arctic", "dbrx", "grok", "plamo",
         "bailingmoe2", "deci", "openelm", "bitnet", "bitnet-25",
         "bitnet-b1.58")


def _later(what: str, item: str):
    """Refuse what a later slice of the port brings; ``item`` names its
    queue item in ROADMAP.md §1."""
    raise NotImplementedError(f"{what} is not ported yet (the {item} slice "
                              "of the PyTorch port)")


def refuse_hidden(family: str, return_hidden: bool, return_layer_hiddens: bool) -> None:
    """The hidden-state outputs of a family whose JAX forward takes them and
    returns logits all the same (``**_``): there is nothing to hold the
    port's hidden states to, so the port raises, naming the family."""
    if return_hidden or return_layer_hiddens:
        raise NotImplementedError(
            f"the hidden states of the {family} family: its JAX forward ignores "
            "return_hidden / return_layer_hiddens and returns logits (ROADMAP.md §3)")


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


class _SwaLayerView:
    """kv.k[i]-style per-layer access over the full and ring stacks."""

    def __init__(self, cache: "SwaKVCache", field: str):
        self._c = cache
        self._f = field

    def __getitem__(self, i: int) -> torch.Tensor:
        m = self._c.layer_map[i]
        if m >= 0:
            return getattr(self._c, self._f + "_full")[m]
        return getattr(self._c, self._f + "_swa")[-m - 1]


@dataclass
class SwaKVCache:
    """--swa-compress: the sliding-window layers keep a ring of about
    window + margin rows instead of the full capacity (reference
    llama.cpp:1198-1227); for gemma3- or gpt-oss-class models, whose layers
    are mostly sliding-window, that cuts the cache by capacity / ring on
    those layers. Position p lives in ring slot p % ring, and attention
    recovers each slot's absolute position, so the logits are those of the
    full cache. bf16 only. Rows are written in place."""

    k_full: torch.Tensor    # (Lf, B, S, Hkv, D)
    v_full: torch.Tensor
    k_swa: torch.Tensor     # (Ls, B, ring, Hkv, D)
    v_swa: torch.Tensor
    layer_map: tuple = ()   # m >= 0 -> full[m]; m < 0 -> swa[-m-1]

    @property
    def k(self):
        return _SwaLayerView(self, "k")

    @property
    def v(self):
        return _SwaLayerView(self, "v")

    @property
    def quantized(self) -> bool:
        return False

    @property
    def capacity(self) -> int:
        return self.k_full.shape[2]

    @property
    def swa_cap(self) -> int:
        return self.k_swa.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k_swa.device

    def ring(self, i: int) -> int:
        """Layer i's ring length, 0 for a full-capacity layer."""
        return self.swa_cap if self.layer_map[i] < 0 else 0

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int, device,
               margin: int = 576):
        """``margin`` must cover the largest prefill chunk, so that a ring
        write never overwrites a row still inside the window of a query of
        its chunk."""
        if cfg.swa_window <= 0:
            raise ValueError("--swa-compress needs sliding-window layers")
        sw_cap = -(-(cfg.swa_window + margin) // 128) * 128
        if sw_cap >= capacity:
            raise ValueError(f"--swa-compress has no effect: ring {sw_cap} >= "
                             f"capacity {capacity}")
        lm, nf, ns = [], 0, 0
        for i in range(cfg.n_layer):
            if cfg.layer_is_swa(i):
                lm.append(-ns - 1)
                ns += 1
            else:
                lm.append(nf)
                nf += 1
        if not ns:
            raise ValueError("--swa-compress has no effect: no sliding-window layers")
        hkv, d = cfg.n_head_kv, cfg.head_dim

        def zeros(n, rows):
            return torch.zeros((n, batch, rows, hkv, d), dtype=torch.bfloat16, device=device)
        return cls(zeros(nf, capacity), zeros(nf, capacity), zeros(ns, sw_cap),
                   zeros(ns, sw_cap), tuple(lm))


def load_llama_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                      use_quant: bool = True, fuse: bool = False) -> dict:
    """GGUF -> nested dict of device tensors and linear modules.

    ``fuse`` merges q/k/v and gate/up into single matmuls at load. Every
    ``blk.N.*`` tensor is consumed or refused: one that the graph does not
    apply (a norm bias under RMS norms, an unknown name, a block past
    ``block_count`` that is not a NextN block) raises, so a model never
    runs with a tensor silently dropped. Trailing NextN/MTP blocks are
    loaded into ``params["mtp_blocks"]``, which ``mtp_forward`` runs."""
    if cfg.arch not in ARCHS:
        _later(f"architecture {cfg.arch!r}, which has a forward of its own",
               "other architectures (item 8)")
    t = gg.tensors
    used: set = set()

    def take(name: str):
        used.add(name)
        return t[name]

    def linear(name: str, quant: bool = use_quant):
        return load_linear(take(name), device, use_quant=quant)

    def dense(name: str):
        return load_dense(take(name), device)

    def bf16(name: str):
        return _t(dequant_tensor(take(name)), device, torch.bfloat16)

    params: dict = {"tok_embd": bf16("token_embd.weight")}
    if "position_embd.weight" in t:          # gpt2/starcoder learned positions
        params["pos_embd"] = dense("position_embd.weight")
    for key, name in (("tok_norm", "token_embd_norm.weight"),   # bloom
                      ("tok_norm_b", "token_embd_norm.bias"),
                      ("output_norm", "output_norm.weight"),
                      ("output_norm_b", "output_norm.bias"),
                      ("output_b", "output.bias")):               # lm-head bias
        if name in t:
            params[key] = dense(name)
    params["output"] = linear("output.weight" if "output.weight" in t
                              else "token_embd.weight")
    layer_norm = cfg.norm_type == "layer"

    blocks, mtp_blocks = [], []
    for i in range(cfg.n_layer + cfg.nextn_layers):
        p = f"blk.{i}."
        if i >= cfg.n_layer and p + "nextn.eh_proj.weight" not in t:
            continue        # not an MTP block: its tensors are refused below
        blk: dict = {}
        if p + "attn_output.weight" in t:  # absent on deci attention-free layers
            blk["wo"] = linear(p + "attn_output.weight")
        for key, name in (("attn_norm", "attn_norm"),     # absent: olmo's LN
                          ("attn_norm_2", "attn_norm_2")):  # falcon-40B
            if p + name + ".weight" in t:
                blk[key] = dense(p + name + ".weight")
        if cfg.arch in ("gpt-oss", "seed_oss"):
            # their pre-FFN norm is stored as post_attention_norm
            blk["ffn_norm"] = dense(p + "post_attention_norm.weight")
        elif cfg.arch == "dbrx":          # dbrx's pre-MoE norm
            blk["ffn_norm"] = dense(p + "attn_output_norm.weight")
        elif p + "ffn_norm.weight" in t:
            blk["ffn_norm"] = dense(p + "ffn_norm.weight")
        if p + "attn_qkv.weight" in t:    # fused QKV (phi3, gpt2, falcon, ...)
            blk["wqkv"] = linear(p + "attn_qkv.weight")
        elif p + "attn_q.weight" in t:
            for key, name in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v")):
                blk[key] = linear(p + name + ".weight")
        if p + "ffn_gate_inp.weight" in t:       # routed experts
            # the router stays a bf16 dense product, as in the JAX package
            blk["ffn_gate_inp"] = linear(p + "ffn_gate_inp.weight", False)
            if p + "ffn_gate_inp.bias" in t:     # router bias (gpt-oss)
                blk["ffn_gate_inp_b"] = dense(p + "ffn_gate_inp.bias")
            used.update(p + nm for nm in _EXPERT_TENSORS if p + nm in t)
            blk["experts"] = _load_experts(t, p, device, use_quant=use_quant)
            if p + "ffn_gate_shexp.weight" in t:  # shared expert
                for name in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                    blk[name] = linear(p + name + ".weight")
                if p + "ffn_gate_inp_shexp.weight" in t:
                    blk["ffn_gate_inp_shexp"] = linear(p + "ffn_gate_inp_shexp.weight", False)
        if p + "ffn_up.weight" in t:
            # a dense FFN, possibly beside experts (arctic, grok); phi3-style
            # models fuse gate and up into one ffn_up tensor
            if p + "ffn_gate.weight" in t:
                blk["ffn_gate"] = linear(p + "ffn_gate.weight")
            blk["ffn_up"] = linear(p + "ffn_up.weight")
            blk["ffn_down"] = linear(p + "ffn_down.weight")
        for opt in ("attn_q_norm", "attn_k_norm"):
            if p + opt + ".weight" in t:
                blk[opt] = dense(p + opt + ".weight")
        if cfg.arch not in ("gpt-oss", "seed_oss"):
            # sandwich norms on the attention and FFN branches
            for key, name in (("attn_post_norm", "post_attention_norm"),
                              ("ffn_post_norm", "post_ffw_norm")):
                if p + name + ".weight" in t:
                    blk[key] = dense(p + name + ".weight")
        if cfg.arch == "grok":
            # grok's sandwich norms: attn_output_norm on the attention
            # output, layer_output_norm (or post_ffw_norm) on the FFN's
            blk["attn_post_norm"] = dense(p + "attn_output_norm.weight")
            for name in ("layer_output_norm", "post_ffw_norm"):
                if p + name + ".weight" in t:
                    blk["ffn_post_norm"] = dense(p + name + ".weight")
                    break
        if p + "ffn_norm_exps.weight" in t:      # arctic's parallel-MoE norm
            blk["ffn_norm_exps"] = dense(p + "ffn_norm_exps.weight")
        if p + "exp_probs_b.bias" in t:          # expert selection bias
            blk["ffn_exp_probs_b"] = dense(p + "exp_probs_b.bias")
        biases = ["attn_q.bias", "attn_k.bias", "attn_v.bias", "attn_qkv.bias",
                  "attn_output.bias", "ffn_up.bias", "ffn_down.bias", "ffn_gate.bias"]
        if layer_norm:                           # RMS norms have no bias
            biases += ["attn_norm.bias", "attn_norm_2.bias", "ffn_norm.bias"]
        for opt_b in biases:
            if p + opt_b in t:
                blk[opt_b.replace(".", "_")] = dense(p + opt_b)
        for sub in ("attn_sub_norm", "ffn_sub_norm"):   # bitnet inner norms
            if p + sub + ".weight" in t:
                blk[sub] = dense(p + sub + ".weight")
        # bitnet per-tensor scales, folded into the weights at load
        for key, name in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                          ("wo", "attn_output"), ("ffn_gate", "ffn_gate"),
                          ("ffn_up", "ffn_up"), ("ffn_down", "ffn_down")):
            if p + name + ".scale" in t and key in blk:
                blk[key] = scale_linear(blk[key], dense(p + name + ".scale"))
        if p + "attn_gate.weight" in t and cfg.arch in ("step35", "laguna"):
            blk["attn_gate"] = linear(p + "attn_gate.weight")    # output gate
        for name in ("attn_sinks.weight", "attn_sinks"):
            if p + name in t:                    # per-head sink logits
                blk["attn_sinks"] = dense(p + name)
                break
        if i >= cfg.n_layer:
            # a trailing NextN/MTP block: its own attention and FFN plus
            # the eh_proj / enorm / hnorm glue
            blk["eh_proj"] = linear(p + "nextn.eh_proj.weight")
            blk["enorm"] = dense(p + "nextn.enorm.weight")
            blk["hnorm"] = dense(p + "nextn.hnorm.weight")
            if p + "nextn.shared_head_norm.weight" in t:
                blk["shead_norm"] = dense(p + "nextn.shared_head_norm.weight")
            if p + "nextn.shared_head.head.weight" in t:
                blk["shead"] = linear(p + "nextn.shared_head.head.weight")
            if p + "nextn.embed_tokens.weight" in t:
                blk["mtp_embd"] = bf16(p + "nextn.embed_tokens.weight")
            mtp_blocks.append(blk)
            continue
        if fuse:
            _fuse_block(blk)
        blocks.append(blk)
    for name in t:
        if name.startswith("blk.") and name not in used:
            raise NotImplementedError(
                f"tensor {name!r}: the {cfg.arch} graph does not apply it")
    params["blocks"] = blocks
    if mtp_blocks:
        params["mtp_blocks"] = mtp_blocks
    return params


def mtp_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                hidden: torch.Tensor, kv: KVCache, n_past):
    """The NextN/MTP layer step (build_glm4_moe_mtp): predict the token at
    position p+2 from the main model's pre-output-norm hidden state at
    position p and the token at p+1.

    tokens: (B, T) the p+1 tokens; hidden: (B, T, E) the main model's
    hidden at p; kv: a 1-layer KVCache for the MTP layer, whose rows
    [n_past, n_past + T) are written in place. Returns (logits f32 (B, T,
    V), kv, hidden') where hidden' (f32) is the MTP layer's own output
    stream, which chained drafts feed back."""
    mtp = params["mtp_blocks"][0]
    b, t = tokens.shape
    dev = kv.device
    embd = mtp.get("mtp_embd", params["tok_embd"])
    emb = embd[tokens].float()
    x = torch.cat([L.rms_norm(emb, mtp["enorm"], cfg.rms_eps),
                   L.rms_norm(hidden.float(), mtp["hnorm"], cfg.rms_eps)], dim=-1)
    x = mtp["eh_proj"](x.to(torch.bfloat16)).to(torch.bfloat16)
    n_past = [int(n_past)] * b if np.ndim(n_past) == 0 else [int(n) for n in n_past]
    npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
    q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    # the MTP layer's rope is unscaled, as in the JAX package
    cos, sin = L.rope_cache(q_pos, cfg.rope_dim or cfg.head_dim, cfg.rope_freq_base)
    h = _norm(x, mtp.get("attn_norm"), mtp.get("attn_norm_bias"), cfg)
    attn_out = _attn_block(mtp, h, cfg, kv, 0, n_past, npv, q_pos, cos, sin)
    if "attn_post_norm" in mtp:
        attn_out = L.rms_norm(attn_out, mtp["attn_post_norm"], cfg.rms_eps)
    x = x + attn_out.to(x.dtype)
    h = _norm(x, mtp.get("ffn_norm"), mtp.get("ffn_norm_bias"), cfg)
    x = x + _ffn(mtp, h, cfg).to(x.dtype)
    y = L.rms_norm(x, mtp.get("shead_norm", params.get("output_norm")), cfg.rms_eps)
    head = mtp.get("shead", params["output"])
    logits = head(y.to(torch.bfloat16)).float()
    return logits, kv, x.float()


_EXPERT_TENSORS = ("ffn_gate_exps.weight", "ffn_up_exps.weight", "ffn_down_exps.weight",
                   "ffn_gate_exps.bias", "ffn_up_exps.bias", "ffn_down_exps.bias")


def _fuse_block(blk: dict) -> None:
    """Merge separate q/k/v (and gate/up) into fused linears in place; never
    where they carry biases."""
    if all(k in blk for k in ("wq", "wk", "wv")) and not any(
            k in blk for k in ("attn_q_bias", "attn_k_bias", "attn_v_bias")):
        fused = fuse_linears([blk["wq"], blk["wk"], blk["wv"]])
        if fused is not None:
            blk["wqkv"] = fused
            del blk["wq"], blk["wk"], blk["wv"]
    if "ffn_gate" in blk and "ffn_up" in blk and not any(
            k in blk for k in ("ffn_gate_bias", "ffn_up_bias")):
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
        q8, sw = requant_rows(pw.codes, pw.scale, pw.group, device)  # (G*N, K)
        codes_t = q8.reshape(g, n, k)                                 # (G, N, K)
        sw = sw.reshape(g, n, k // SUPERGROUP).transpose(1, 2).contiguous()
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


def _norm(x: torch.Tensor, w, b, cfg: ModelConfig) -> torch.Tensor:
    """The model's norm: LayerNorm (with its bias) or RMS norm."""
    if cfg.norm_type == "layer":
        return L.layer_norm(x, w, b, cfg.rms_eps)
    return L.rms_norm(x, w, cfg.rms_eps)


def _act_limit(cfg: ModelConfig, il: int, shared: bool = False) -> float:
    lims = (cfg.extra or {}).get("swiglu_limits_shared" if shared else "swiglu_limits")
    return float(lims[il]) if lims else 0.0


def _ffn(blk: dict, h: torch.Tensor, cfg: ModelConfig, il: int = 0) -> torch.Tensor:
    """Dense or routed-expert feed-forward on (B, T, E) normalized input;
    a shared expert, gated by a sigmoid where the model has the gate, adds
    to the routed ones, and grok's dense FFN to both."""
    if "experts" not in blk:
        return _ffn_dense(blk, h, cfg, il)
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
    if cfg.arch == "grok" and "ffn_up" in blk:
        # the dense FFN and the experts read the same input; their sum is
        # scaled by sqrt(2)/2
        y = (y + _ffn_dense(blk, h, cfg, il)) * float(np.sqrt(2.0) / 2.0)
    return y


def _ffn_dense(blk: dict, h: torch.Tensor, cfg: ModelConfig, il: int = 0) -> torch.Tensor:
    if "ffn_gate" in blk:
        gate = blk["ffn_gate"](h)
        up = blk["ffn_up"](h)
        if "ffn_gate_bias" in blk:
            gate = gate + blk["ffn_gate_bias"]
        if "ffn_up_bias" in blk:
            up = up + blk["ffn_up_bias"]
    else:
        both = blk["ffn_up"](h)
        if "ffn_up_bias" in blk:
            both = both + blk["ffn_up_bias"]
        # this layer's width (deci/openelm have one a layer) tells a lone up
        # projection from gate and up fused into one matmul
        if both.shape[-1] == (cfg.n_ff_arr[il] if cfg.n_ff_arr else cfg.n_ff):
            # no gate (starcoder2, gpt2, ...): act(up)
            y = L.gelu(both.float()) if cfg.act == "gelu" else L.silu(both.float())
            y = blk["ffn_down"](y.to(torch.bfloat16))
            if "ffn_down_bias" in blk:
                y = y + blk["ffn_down_bias"]
            return y
        gate, up = torch.chunk(both, 2, dim=-1)
    act = L.glu(gate, up, cfg.act, limit=_act_limit(cfg, il)).to(torch.bfloat16)
    if "ffn_sub_norm" in blk:        # bitnet inner norm before ffn_down
        act = L.rms_norm(act, blk["ffn_sub_norm"], cfg.rms_eps).to(torch.bfloat16)
    y = blk["ffn_down"](act)
    if "ffn_down_bias" in blk:
        y = y + blk["ffn_down_bias"]
    return y


def _heads(slab, hkv: int):
    """A layer slab's leading ``hkv`` kv heads (deci/openelm allocate the
    cache at the largest count): a view."""
    return slab if slab is None or slab.shape[2] == hkv else slab[:, :, :hkv]


def _ring_positions(kv_len: torch.Tensor, ring: int) -> torch.Tensor:
    """(B, ring) absolute position of each ring slot: the last position
    congruent to the slot below the fill level, -1 for an unwritten slot."""
    slots = torch.arange(ring, dtype=torch.int32, device=kv_len.device)[None, :]
    kvl = kv_len.to(torch.int32)[:, None]
    pos = slots + torch.div(kvl - 1 - slots, ring, rounding_mode="floor") * ring
    return torch.where(slots < torch.clamp(kvl, max=ring), pos, torch.full_like(pos, -1))


def _probe_attend(qb, ka, va, q_pos, npv, kv_len, block_mask, **kw) -> torch.Tensor:
    """Attention of a probe block (lookahead, tree decoding): the block's
    queries sit at explicit positions ``q_pos`` and see the committed
    prefix (slots below n_past, slot == position) and the block's own slots
    n_past + j, each holding position q_pos[:, j], as far as ``block_mask``
    (T, T) allows. The JAX forward's probe branch, on the plain
    ``attend``."""
    b, t = q_pos.shape
    s = ka.shape[1]
    dev = qb.device
    slots = torch.arange(s, device=dev)[None, :]                      # (1, S)
    blk_j = slots - npv.long()[:, None]                               # (B, S)
    in_blk = (blk_j >= 0) & (blk_j < t)
    blk_jc = blk_j.clamp(0, t - 1)
    committed = slots < npv.long()[:, None]
    grid_pos = torch.gather(q_pos.long(), 1, blk_jc)
    key_pos = torch.where(committed, slots, torch.where(in_blk, grid_pos,
                                                        torch.full_like(grid_pos, -1)))
    bm = block_mask.to(device=dev, dtype=torch.bool).expand(b, t, t)
    bm_g = torch.gather(bm, 2, blk_jc[:, None, :].expand(b, t, s))     # (B, T, S)
    allow = committed[:, None, :] | (in_blk[:, None, :] & bm_g)
    return attend(qb, ka, va, q_pos=q_pos, kv_len=kv_len, key_positions=key_pos,
                  allow_mask=allow, **kw)


def _attn_block(blk: dict, x: torch.Tensor, cfg: ModelConfig, kv, il: int,
                n_past: list[int], npv: torch.Tensor, q_pos: torch.Tensor,
                cos, sin, *, swa_window: int = 0, n_head: int | None = None,
                n_head_kv: int | None = None, attn_chunk: int = 0,
                attn_scale_vec: torch.Tensor | None = None,
                n_valid: list[int] | None = None,
                block_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One attention sublayer over (B, T, E). Writes this chunk's K/V rows
    into layer ``il`` of the cache in place (quantized with the layer's
    codec when the cache is; at slot p % ring on a ring layer, where rows
    past a row's ``n_valid`` are dropped), then attends over that layer's
    slab: a decode kernel for T <= 16, a prefill kernel otherwise. ALiBi
    models, ring layers and a probe block (``block_mask``, ``_probe_attend``)
    attend by the plain ``ops/attention.attend``, as the JAX package runs
    XLA there and no Pallas kernel. ``cos`` None is a NoPE layer;
    ``swa_window`` > 0 limits each query to that many most recent keys;
    ``n_head`` / ``n_head_kv`` are the layer's own head counts
    (deci/openelm)."""
    b, t, _ = x.shape
    h = cfg.n_head if n_head is None else n_head
    hkv = cfg.n_head_kv if n_head_kv is None else n_head_kv
    d = cfg.head_dim
    if "wqkv" in blk:
        qkv = blk["wqkv"](x)
        if "attn_qkv_bias" in blk:
            qkv = qkv + blk["attn_qkv_bias"]
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
    if cfg.clamp_kqv > 0:                        # mpt/olmo
        c = cfg.clamp_kqv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    q, k, v = q.reshape(b, t, h, d), k.reshape(b, t, hkv, d), v.reshape(b, t, hkv, d)
    if "attn_q_norm" in blk:
        qn, kn = blk["attn_q_norm"], blk["attn_k_norm"]
        if qn.dim() == 1 and qn.shape[0] == h * d and d != h * d:
            # minimax-m2: RMS over the whole projection before the head split
            q = L.rms_norm(q.reshape(b, t, h * d), qn, cfg.rms_eps).reshape(b, t, h, d)
            k = L.rms_norm(k.reshape(b, t, hkv * d), kn, cfg.rms_eps).reshape(b, t, hkv, d)
        elif cfg.norm_type == "layer":           # stablelm: per-head LayerNorm
            q = L.layer_norm(q, qn, None, cfg.rms_eps)
            k = L.layer_norm(k, kn, None, cfg.rms_eps)
        else:                                    # per-head RMS norm
            q = L.rms_norm(q, qn, cfg.rms_eps)
            k = L.rms_norm(k, kn, cfg.rms_eps)
    if cfg.qk_l2_norm and cos is not None:       # llama4's weightless L2 norm
        q, k = L.rms_norm(q, None, cfg.rms_eps), L.rms_norm(k, None, cfg.rms_eps)
    if cos is not None:
        q = L.apply_rope(q, cos, sin, cfg.rope_type)
        k = L.apply_rope(k, cos, sin, cfg.rope_type)
    if attn_scale_vec is not None:               # llama4 NoPE-layer temperature
        q = (q.float() * attn_scale_vec[..., None, None]).to(q.dtype)
    # -khad / -vhad: rotate K and q (scores unchanged) and/or V by a head-dim
    # Hadamard before the cache write; V is un-rotated after attention
    if cfg.k_hadamard:
        k, q = hadamard_rotate(k), hadamard_rotate(q)
    if cfg.v_hadamard:
        v = hadamard_rotate(v)

    k_slab, v_slab = kv.k[il], kv.v[il]          # views (B, S, Hkv, W)
    kw = dict(scale=cfg.f_attention_scale or (1.0 / float(np.sqrt(d))),
              softcap=cfg.attn_softcap, swa_window=swa_window, attn_chunk=attn_chunk,
              sinks=blk.get("attn_sinks"))
    kv_len = npv + t
    qb = q.to(torch.bfloat16)
    ring = kv.ring(il) if isinstance(kv, SwaKVCache) else 0
    alibi = (alibi_slopes(h, cfg.alibi_max_bias) if cfg.alibi_max_bias > 0 else None)
    if ring:
        if block_mask is not None:
            raise ValueError("a block_mask probe does not run on a ring cache layer")
        for bb in range(b):
            # a padded row would wrap onto a live window row: only the
            # row's first n_valid positions are written
            n = t if n_valid is None else n_valid[bb]
            rows = (torch.arange(n, device=k.device) + n_past[bb]) % ring
            k_slab[bb, rows, :hkv] = k[bb, :n].to(k_slab.dtype)
            v_slab[bb, rows, :hkv] = v[bb, :n].to(v_slab.dtype)
        attn = attend(qb, _heads(k_slab, hkv), _heads(v_slab, hkv), q_pos=q_pos,
                      kv_len=kv_len, key_positions=_ring_positions(kv_len, ring), **kw)
    elif not kv.quantized:
        for bb in range(b):
            n = n_past[bb]
            k_slab[bb, n:n + t, :hkv] = k[bb].to(k_slab.dtype)
            v_slab[bb, n:n + t, :hkv] = v[bb].to(v_slab.dtype)
        ka, va = _heads(k_slab, hkv), _heads(v_slab, hkv)
        if block_mask is not None:
            attn = _probe_attend(qb, ka, va, q_pos, npv, kv_len, block_mask, alibi=alibi, **kw)
        elif alibi is not None:
            attn = attend(qb, ka, va, q_pos=q_pos, kv_len=kv_len, scale=kw["scale"],
                          softcap=cfg.attn_softcap, swa_window=swa_window, alibi=alibi)
        else:
            attn_fn = flash_attention_decode if t <= DECODE_MAX_T else flash_attention
            attn = attn_fn(qb, ka, va, npv, kv_len, **kw)
    else:
        ks_slab, vs_slab = kv.k_scale[il], kv.v_scale[il]     # (B, S, Hkv)
        codec = kv_codec_of(k_slab, d)
        kq, ks = KV_ENCODERS[codec](k)            # quantize on write
        vq, vs = KV_ENCODERS[codec](v)
        for bb in range(b):
            n = n_past[bb]
            k_slab[bb, n:n + t, :hkv], ks_slab[bb, n:n + t, :hkv] = kq[bb], ks[bb]
            v_slab[bb, n:n + t, :hkv], vs_slab[bb, n:n + t, :hkv] = vq[bb], vs[bb]
        ka, ksa, va, vsa = (_heads(a, hkv) for a in (k_slab, ks_slab, v_slab, vs_slab))
        dec = KV_DECODERS[codec]
        if block_mask is not None:
            attn = _probe_attend(qb, dec(ka, ksa).to(torch.bfloat16),
                                 dec(va, vsa).to(torch.bfloat16), q_pos, npv, kv_len,
                                 block_mask, alibi=alibi, **kw)
        elif alibi is not None:
            attn = attend(qb, dec(ka, ksa).to(torch.bfloat16),
                          dec(va, vsa).to(torch.bfloat16), q_pos=q_pos, kv_len=kv_len,
                          scale=kw["scale"], softcap=cfg.attn_softcap,
                          swa_window=swa_window, alibi=alibi)
        elif t <= DECODE_MAX_T:
            attn = flash_attention_decode_q8(qb, ka, ksa, va, vsa, npv, kv_len, **kw)
        elif codec == "q8":
            attn = flash_attention_q8(qb, ka, ksa, va, vsa, npv, kv_len, **kw)
        else:
            # the packed codecs have no fused prefill kernel: the filled
            # rows are decoded to bf16 for the bf16 prefill kernel
            fill = max(n_past) + t
            attn = flash_attention(
                qb, dec(ka[:, :fill], ksa[:, :fill]).to(torch.bfloat16),
                dec(va[:, :fill], vsa[:, :fill]).to(torch.bfloat16), npv, kv_len, **kw)
    if cfg.v_hadamard:
        attn = hadamard_rotate(attn)   # attn = A @ (V H), so attn @ H = A @ V
    if "attn_gate" in blk:
        # step35: a sigmoid gate; laguna: softplus; per head or per element
        gate = blk["attn_gate"](x).float()
        gate = (torch.nn.functional.softplus(gate) if cfg.arch == "laguna"
                else torch.sigmoid(gate))
        if gate.shape[-1] == h:
            attn = attn * gate[..., None].to(attn.dtype)
        else:
            attn = attn * gate.reshape(b, t, h, d).to(attn.dtype)
    attn = attn.reshape(b, t, h * d)
    if "attn_sub_norm" in blk:       # bitnet inner norm before the out proj
        attn = L.rms_norm(attn, blk["attn_sub_norm"], cfg.rms_eps)
    out = blk["wo"](attn)
    if "attn_output_bias" in blk:
        out = out + blk["attn_output_bias"]
    return out


# forward() arguments of the JAX package that later slices bring, by the
# queue item of ROADMAP.md §1 that brings them
_LATER_ARGS = {
    "collect_stats": "device tools (item 9)", "tp_axis": "multi-GPU (item 11)",
    "ep_axis": "multi-GPU (item 11)", "sp_axis": "multi-GPU (item 11)",
    "layer_offset": "multi-GPU (item 11)", "return_raw_stream": "multi-GPU (item 11)",
}


def _rope_tables(cfg: ModelConfig, q_pos: torch.Tensor, dims: int):
    """(cos, sin, cos_swa, sin_swa) of ``dims`` rotary dims: the model's
    rope (linear / yarn scaled), and the sliding-window layers' own base,
    unscaled, where the model has one."""
    freq_scale = (1.0 / cfg.rope_scale_factor
                  if cfg.rope_scaling in ("linear", "yarn")
                  and cfg.rope_scale_factor not in (0.0, 1.0) else 1.0)
    ext_factor = 1.0 if (cfg.rope_scaling == "yarn" and freq_scale != 1.0) else 0.0
    cos, sin = L.rope_cache(q_pos, dims, cfg.rope_freq_base, freq_scale,
                            ext_factor=ext_factor, attn_factor=cfg.rope_attn_factor or 1.0,
                            n_ctx_orig=cfg.rope_orig_ctx or cfg.n_ctx_train)
    if cfg.rope_freq_base_swa > 0 and cfg.swa_layer_mask:
        return (cos, sin, *L.rope_cache(q_pos, dims, cfg.rope_freq_base_swa))
    return cos, sin, cos, sin


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, kv,
            n_past, *, npv: torch.Tensor | None = None,
            logits_last_only: bool = False, return_hidden: bool = False,
            return_mtp_hidden: bool = False, return_layer_hiddens: bool = False,
            inputs_embeds: torch.Tensor | None = None, positions=None,
            block_mask=None, n_valid=None, **later):
    """tokens: (B, T) on the cache's device; n_past: int or per-row list of
    ints (host); npv: the same as an int32 (B,) device tensor, made here
    when not given. Writes the chunk into ``kv`` in place and returns the
    float32 logits (B, T or 1, V); with ``return_hidden`` the final-norm
    hidden states (B, T, E) f32 instead (embedding extraction); with
    ``return_mtp_hidden`` (logits, the pre-output-norm residual stream of
    every position (B, T, E) f32), the MTP layer's input; with
    ``return_layer_hiddens`` every layer's output (L, B, T, E) f32 (the
    control-vector generator's input).

    ``inputs_embeds`` (B, T, E) replaces the token-embedding lookup;
    ``positions`` (T,) or (B, T) gives each token's absolute position (rope
    and learned positions follow it; the rows are still written at n_past
    + j); ``block_mask`` (T, T) bool makes the chunk a probe block whose
    queries see the committed prefix and the block rows it allows
    (``_probe_attend``). ``n_valid`` (an int, or one a row; host ints) is
    the chunk's live length: a ring layer drops the writes past it, and
    causal rows past it never feed a live row, so nothing else changes.
    The JAX forward's other arguments raise NotImplementedError naming the
    slice that brings them."""
    for name in later:
        if name not in _LATER_ARGS:
            raise TypeError(f"forward() got an unexpected keyword argument {name!r}")
        _later(f"forward's {name!r}", _LATER_ARGS[name])
    b, t = tokens.shape
    dev = kv.device
    n_past = [int(n_past)] * b if np.ndim(n_past) == 0 else [int(n) for n in n_past]
    if npv is None:
        npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
    if n_valid is not None:
        n_valid = [int(n_valid)] * b if np.ndim(n_valid) == 0 else [int(n) for n in n_valid]
    if inputs_embeds is not None:
        x = inputs_embeds.to(device=dev, dtype=torch.bfloat16)
    else:
        x = params["tok_embd"][tokens]                  # (B, T, E) bf16
    if cfg.embd_scale > 0:                              # gemma input scaling
        x = (x.float() * cfg.embd_scale).to(x.dtype)
    if positions is not None:
        q_pos = torch.as_tensor(positions, dtype=torch.int32, device=dev).reshape(-1, t)
        q_pos = q_pos.expand(b, t)
    else:
        q_pos = npv[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    if "pos_embd" in params:                            # learned positions
        x = x + params["pos_embd"][q_pos].to(x.dtype)
    if "tok_norm" in params:                            # bloom embedding norm
        x = _norm(x, params["tok_norm"], params.get("tok_norm_b"), cfg)
    rope_dims = cfg.rope_dim or cfg.head_dim
    cos, sin, cos_swa, sin_swa = _rope_tables(cfg, q_pos, rope_dims)
    sections = (cfg.extra or {}).get("rope_sections") or []
    if sum(sections):
        # qwen3vl imrope: the pairs of the "extra" stream hold position 0
        # for text tokens, so they do not rotate
        m = torch.from_numpy(L.imrope_text_mask(sections, rope_dims)).to(dev)
        cos = torch.where(m, cos, torch.ones_like(cos))
        sin = torch.where(m, sin, torch.zeros_like(sin))
        if not (cfg.rope_freq_base_swa > 0 and cfg.swa_layer_mask):
            cos_swa, sin_swa = cos, sin
    rope_arr = (cfg.extra or {}).get("rope_dim_arr")
    # step35: rotary dims a layer; an n-dim rope has its own frequencies
    by_dim = ({dd: _rope_tables(cfg, q_pos, dd) for dd in set(rope_arr)}
              if rope_arr else {})
    attn_temp = None
    if cfg.attn_temp_scale > 0:                         # llama4 NoPE temperature
        attn_temp = (torch.log(torch.floor((q_pos.float() + 1.0) / cfg.attn_temp_floor)
                               + 1.0) * cfg.attn_temp_scale + 1.0)
    layer_hiddens = []
    for i, blk in enumerate(params["blocks"]):
        x_layer_in = x       # arctic's parallel MoE branch reads the layer input
        is_swa = cfg.layer_is_swa(i)
        tabs = by_dim[int(rope_arr[i])] if rope_arr else (cos, sin, cos_swa, sin_swa)
        cos_l, sin_l = tabs[2:] if is_swa else tabs[:2]
        nope = ((not cfg.use_rope)
                or (cfg.no_rope_step > 0 and (i + 1) % cfg.no_rope_step == 0)
                or (bool(cfg.nope_layer_mask) and cfg.nope_layer_mask[i]))
        n_head_l = cfg.n_head_arr[i] if cfg.n_head_arr else cfg.n_head
        n_head_kv_l = cfg.n_head_kv_arr[i] if cfg.n_head_kv_arr else cfg.n_head_kv
        n_ff_l = cfg.n_ff_arr[i] if cfg.n_ff_arr else None
        h = (_norm(x, blk.get("attn_norm"), blk.get("attn_norm_bias"), cfg)
             if ("attn_norm" in blk or cfg.norm_type == "layer" or n_head_l > 0) else x)
        # falcon-40B: the attention reads its own second norm, the FFN attn_norm's
        h_attn = (_norm(x, blk["attn_norm_2"], blk.get("attn_norm_2_bias"), cfg)
                  if "attn_norm_2" in blk else h)
        if n_head_l == 0:                  # deci attention-free layer
            attn_out = torch.zeros_like(x)
        elif n_head_kv_l == 0:             # deci "linear attention": wo alone
            attn_out = blk["wo"](h_attn)
        else:
            chunk_l = cfg.attn_chunk if (cfg.attn_chunk > 0 and (
                not cfg.swa_layer_mask or cfg.swa_layer_mask[i])) else 0
            attn_out = _attn_block(blk, h_attn, cfg, kv, i, n_past, npv, q_pos,
                                   None if nope else cos_l, None if nope else sin_l,
                                   swa_window=cfg.swa_window if is_swa else 0,
                                   n_head=n_head_l, n_head_kv=n_head_kv_l,
                                   attn_chunk=chunk_l,
                                   attn_scale_vec=attn_temp if nope else None,
                                   n_valid=n_valid, block_mask=block_mask)
        if "attn_post_norm" in blk:            # sandwich norm on the branch
            attn_out = L.rms_norm(attn_out, blk["attn_post_norm"], cfg.rms_eps)
        if cfg.residual_branch_scale > 0:      # minicpm
            attn_out = attn_out * cfg.residual_branch_scale
        if cfg.parallel_residual or (cfg.arch == "stablelm" and "ffn_norm" not in blk):
            # command-r / falcon / phi2: the FFN reads the same normed input
            # (gptneox: its own LayerNorm over the layer input) and both
            # branches add into the residual together
            h_ffn = (_norm(x, blk["ffn_norm"], blk.get("ffn_norm_bias"), cfg)
                     if cfg.par_res_separate_norm and "ffn_norm" in blk else h)
            ff = _ffn(blk, h_ffn, cfg, i)
            if cfg.residual_branch_scale > 0:
                ff = ff * cfg.residual_branch_scale
            x = x + attn_out.to(x.dtype) + ff.to(x.dtype)
        else:
            x = x + attn_out.to(x.dtype)
            if cfg.residual_scale > 0:         # granite scales the whole stream
                x = (x.float() * cfg.residual_scale).to(x.dtype)
            if n_ff_l != 0 and ("ffn_up" in blk or "experts" in blk):
                h = _norm(x, blk.get("ffn_norm"), blk.get("ffn_norm_bias"), cfg)
                # arctic: the sequential FFN is the dense one; the experts
                # run in parallel over the layer input (below)
                ff = (_ffn_dense(blk, h, cfg, i) if "ffn_norm_exps" in blk
                      else _ffn(blk, h, cfg, i))
                if "ffn_post_norm" in blk:
                    ff = L.rms_norm(ff, blk["ffn_post_norm"], cfg.rms_eps)
                if cfg.residual_branch_scale > 0:
                    ff = ff * cfg.residual_branch_scale
                if cfg.moe_normed_residual and "experts" in blk:
                    # build_llama's MoE branch adds the FFN to its normed input
                    x = (h.float() + ff.float()).to(x.dtype)
                else:
                    x = x + ff.to(x.dtype)
                if "ffn_norm_exps" in blk:
                    hx = L.rms_norm(x_layer_in, blk["ffn_norm_exps"], cfg.rms_eps)
                    x = x + _ffn(blk, hx, cfg, i).to(x.dtype)
                if cfg.residual_scale > 0:
                    x = (x.float() * cfg.residual_scale).to(x.dtype)
        if "cvec" in params:                   # control vector at the layer output
            x = x + params["cvec"][i].to(x.dtype)
        if return_layer_hiddens:
            layer_hiddens.append(x.float())
    if return_layer_hiddens:
        return torch.stack(layer_hiddens)
    mtp_hidden = x       # the pre-output-norm stream ("result_mtp_embd")
    x = _norm(x, params.get("output_norm"), params.get("output_norm_b"), cfg)
    if return_hidden:
        return x.float()
    if logits_last_only:
        x = x[:, -1:, :]
    logits = params["output"](x).float()
    if "output_b" in params:                   # lm-head bias
        logits = logits + params["output_b"]
    if cfg.f_logit_scale > 0:                  # granite divides, command-r multiplies
        logits = (logits * cfg.f_logit_scale if cfg.logit_scale_mul
                  else logits / cfg.f_logit_scale)
    if cfg.final_softcap > 0:
        logits = L.softcap(logits, cfg.final_softcap)
    if return_mtp_hidden:
        return logits, mtp_hidden.float()
    return logits
