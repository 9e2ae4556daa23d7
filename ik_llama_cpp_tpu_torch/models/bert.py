"""The BERT encoder family (bert / bge / e5 / minilm embeddings, nomic-bert,
jina-bert-v2): parameters and the forward pass.

The torch counterpart of the JAX package's ``models/bert.py`` (build_bert of
the reference). A post-LN encoder: x = LN(tok + type0 + pos); each layer
x = LN(x + attn(x)), then x = LN(x + FFN(x)); bidirectional attention over
the chunk's valid positions; the output is the last layer's hidden states
(the runtime pools them). Its variants, told apart by the tensors the file
carries and the architecture name:
  * bert: learned absolute positions, biased q/k/v/o, GELU FFN with biases
  * nomic-bert: a fused qkv, NEOX rope, a SiLU-gated FFN, no biases
  * jina-bert-v2: no positions, ALiBi, LayerNorms on q and k, a second
    attention norm that re-adds the layer input, a GELU-gated FFN

There is no KV cache: the whole sequence is encoded in one pass, and
``NoCache`` keeps the runtime's interface. The linears run on the port's
kernels (kernel A for int8 weights on the card); the attention is one
float32 ``scaled_dot_product_attention`` call, as it is XLA in the JAX
package (no Pallas kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from ..ops.attention import alibi_slopes
from .config import ModelConfig
from .weights import _t, dequant_tensor, load_dense, load_linear

ARCHS = ("bert", "nomic-bert", "jina-bert-v2")


@dataclass
class NoCache:
    """An encoder keeps no state between calls: the runtime's cache slot,
    with a capacity that never fills and the device the forward runs on."""

    device: torch.device

    capacity = 1 << 30

    @classmethod
    def create(cls, cfg: ModelConfig = None, batch: int = 1, capacity: int = 0,
               device="cuda", quant=False):
        return cls(torch.device(device))


def load_bert_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                     use_quant: bool = True) -> dict:
    """GGUF -> nested dict of device tensors and linear modules, the JAX
    loader's tree: norms are (weight, bias) pairs, the token embedding bf16,
    positions, token types, norms and biases float32. Every ``blk.N.*``
    tensor is consumed or refused."""
    t = gg.tensors
    used: set = set()

    def take(name: str):
        used.add(name)
        return t[name]

    def linear(name: str):
        return load_linear(take(name), device, use_quant=use_quant)

    def dense(name: str):
        return load_dense(take(name), device)

    def norm(base: str):
        return (dense(base + ".weight"),
                dense(base + ".bias") if base + ".bias" in t else None)

    params: dict = {
        "tok_embd": _t(dequant_tensor(take("token_embd.weight")), device, torch.bfloat16),
        "tok_norm": (dense("token_embd_norm.weight"), dense("token_embd_norm.bias")),
    }
    if "token_types.weight" in t:
        params["type_embd"] = dense("token_types.weight")
    if "position_embd.weight" in t:
        params["pos_embd"] = dense("position_embd.weight")
    blocks = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        blk = {"wo": linear(p + "attn_output.weight"),
               "attn_out_norm": (dense(p + "attn_output_norm.weight"),
                                 dense(p + "attn_output_norm.bias")),
               "ffn_up": linear(p + "ffn_up.weight"),
               "ffn_down": linear(p + "ffn_down.weight"),
               "layer_out_norm": (dense(p + "layer_output_norm.weight"),
                                  dense(p + "layer_output_norm.bias"))}
        if p + "attn_qkv.weight" in t:            # nomic-bert: fused qkv
            blk["wqkv"] = linear(p + "attn_qkv.weight")
        else:
            for n in ("q", "k", "v"):
                blk["w" + n] = linear(p + f"attn_{n}.weight")
                blk["b" + n] = dense(p + f"attn_{n}.bias")
        for name, key in (("attn_output.bias", "bo"), ("ffn_up.bias", "ffn_up_b"),
                          ("ffn_down.bias", "ffn_down_b")):
            if p + name in t:
                blk[key] = dense(p + name)
        if p + "ffn_gate.weight" in t:            # nomic / jina gated FFN
            blk["ffn_gate"] = linear(p + "ffn_gate.weight")
        if p + "attn_q_norm.weight" in t:         # jina: LayerNorms on q and k
            blk["q_norm"] = norm(p + "attn_q_norm")
            blk["k_norm"] = norm(p + "attn_k_norm")
        if p + "attn_norm_2.weight" in t:         # jina: the second attention norm
            blk["attn_norm_2"] = norm(p + "attn_norm_2")
        blocks.append(blk)
    for name in t:
        if name.startswith("blk.") and name not in used:
            raise NotImplementedError(
                f"tensor {name!r}: the {cfg.arch} graph does not apply it")
    params["blocks"] = blocks
    return params


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid, slopes,
            pos: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention, float32: q/k/v (B, T, H, D), valid (B, T)
    bool keys or None when every key is. Returns (B, T, H * D). The padded
    keys and the ALiBi distance (jina-bert-v2) are one additive bias."""
    b, t, h, d = q.shape
    bias = None
    if valid is not None:
        bias = torch.zeros(b, 1, 1, t, dtype=torch.float32, device=q.device)
        bias.masked_fill_(~valid[:, None, None, :], -1e30)
    if slopes is not None:
        dist = (pos[:, None] - pos[None, :]).abs().float()
        alibi = -slopes[None, :, None, None] * dist[None, None]
        bias = alibi if bias is None else bias + alibi
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=bias)
    return out.transpose(1, 2).reshape(b, t, h * d)


def layer_context(cfg: ModelConfig, b: int, t: int, n_valid, dev) -> dict:
    """What every layer of a (B, T) chunk reads: the positions, the valid
    keys (B, T; None when no row is padded), the rope tables (nomic-bert)
    and the ALiBi slopes (jina-bert-v2)."""
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    nv = [t] * b if n_valid is None else (
        [int(n_valid)] * b if np.ndim(n_valid) == 0 else [int(n) for n in n_valid])
    valid = None if min(nv) >= t else (
        pos[None, :] < torch.tensor(nv, dtype=torch.int32, device=dev)[:, None])
    ctx = {"pos": pos, "rope": None, "slopes": None, "valid": valid}
    if cfg.arch == "nomic-bert":
        ctx["rope"] = L.rope_cache(pos[None, :], cfg.rope_dim or cfg.head_dim,
                                   cfg.rope_freq_base)
    if cfg.alibi_max_bias > 0:
        ctx["slopes"] = torch.as_tensor(alibi_slopes(cfg.n_head, cfg.alibi_max_bias),
                                        dtype=torch.float32, device=dev)
    return ctx


def embed_input(params: dict, cfg: ModelConfig, tokens: torch.Tensor, ctx: dict) -> torch.Tensor:
    """The first layer's input (B, T, E) f32: token, type and (bert)
    position embeddings under the embedding LayerNorm."""
    x = params["tok_embd"][tokens].float()
    if "type_embd" in params:
        x = x + params["type_embd"][0]
    if cfg.arch == "bert" and "pos_embd" in params:
        x = x + params["pos_embd"][ctx["pos"]][None]
    return L.layer_norm(x, *params["tok_norm"], cfg.rms_eps)


def layer(blk: dict, x: torch.Tensor, cfg: ModelConfig, ctx: dict) -> torch.Tensor:
    """One post-LN encoder layer over the float32 stream x (B, T, E)."""
    b, t, _ = x.shape
    h, d, eps = cfg.n_head, cfg.head_dim, cfg.rms_eps
    xb = x.to(torch.bfloat16)
    if "wqkv" in blk:
        qkv = blk["wqkv"](xb)
        q, k, v = qkv[..., :h * d], qkv[..., h * d:2 * h * d], qkv[..., 2 * h * d:]
    else:
        q = blk["wq"](xb) + blk["bq"]
        k = blk["wk"](xb) + blk["bk"]
        v = blk["wv"](xb) + blk["bv"]
    if "q_norm" in blk:
        q = L.layer_norm(q, *blk["q_norm"], eps)
        k = L.layer_norm(k, *blk["k_norm"], eps)
    q, k, v = (a.reshape(b, t, h, d) for a in (q, k, v))
    if ctx["rope"] is not None:
        q = L.apply_rope(q, *ctx["rope"], cfg.rope_type)
        k = L.apply_rope(k, *ctx["rope"], cfg.rope_type)
    attn = _attend(q.float(), k.float(), v.float(), ctx["valid"], ctx["slopes"], ctx["pos"])
    out = blk["wo"](attn.to(torch.bfloat16))
    if "bo" in blk:
        out = out + blk["bo"]
    inp = x
    x = L.layer_norm(x + out.float(), *blk["attn_out_norm"], eps)
    if "attn_norm_2" in blk:
        # jina-bert-v2 re-adds the layer input after attn_out_norm
        x = L.layer_norm(x + inp, *blk["attn_norm_2"], eps)
    ffn_inp = x
    xb = x.to(torch.bfloat16)
    ff = blk["ffn_up"](xb)
    if "ffn_up_b" in blk:
        ff = ff + blk["ffn_up_b"]
    if "ffn_gate" in blk:
        act = "gelu" if cfg.arch == "jina-bert-v2" else "silu"
        ff = L.glu(blk["ffn_gate"](xb).float(), ff.float(), act)
    else:
        ff = L.gelu(ff.float())
    ff = blk["ffn_down"](ff.to(torch.bfloat16))
    if "ffn_down_b" in blk:
        ff = ff + blk["ffn_down_b"]
    return L.layer_norm(ffn_inp + ff.float(), *blk["layer_out_norm"], eps)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: NoCache,
            n_past=0, *, return_hidden: bool = True, return_layer_hiddens: bool = False,
            n_valid=None) -> torch.Tensor:
    """tokens: (B, T) on the model's device. Returns the last layer's hidden
    states (B, T, E) f32 (BERT has no LM head, so ``return_hidden`` is
    always so); with ``return_layer_hiddens`` every layer's output (L, B,
    T, E) f32. ``n_valid`` (an int, or one a row; host ints) masks the
    padded positions out of the attention's keys. ``n_past`` and the cache
    are not read: each call encodes its chunk from position 0."""
    ctx = layer_context(cfg, *tokens.shape, n_valid, tokens.device)
    x = embed_input(params, cfg, tokens, ctx)
    layer_hiddens = []
    for blk in params["blocks"]:
        x = layer(blk, x, cfg, ctx)
        if return_layer_hiddens:
            layer_hiddens.append(x)
    if return_layer_hiddens:
        return torch.stack(layer_hiddens)
    return x
