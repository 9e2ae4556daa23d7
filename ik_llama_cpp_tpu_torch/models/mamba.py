"""Mamba (selective state-space) family on a recurrent cache.

The torch counterpart of the JAX package's ``models/mamba.py``, function by
function (build_mamba and ggml's SSM_CONV / SSM_SCAN):
  * ssm_in projects x to [x | z] (2 * d_inner)
  * a causal depthwise conv over x with the last d_conv - 1 inputs carried
    from the previous chunk, its bias, then silu
  * ssm_x projects to [dt_low (dt_rank) | B (d_state) | C (d_state)];
    dt = ssm_dt(dt_low) + dt bias
  * the selective scan, per token:
        dt' = softplus(dt);  state = state * exp(dt' * A) + B (x * dt')
        y   = state . C
  * (y + x * D) * silu(z), then ssm_out

``MambaCache`` holds the conv tails and scan states of every layer, the
batch on axis 1; the forward writes both in place. ``n_valid`` (an int, or
one length a batch row; the JAX forward takes a scalar) bounds what a
bucket-padded chunk commits: past it a step's decay is 1 and its input 0,
so the state is left exactly as it was, and the conv tail ends at the last
valid position. A row with ``n_valid`` 0 keeps both bit for bit.

The linears run on the port's kernels (kernel A for int8 weights on the
card). The conv and the scan are plain PyTorch, as they are XLA in the JAX
package (a ``lax.scan``, no Pallas kernel): the scan's operands
(softplus, the decay, the B x input) are computed for the whole chunk
first, each token is then one launch that writes its state into a buffer
of the chunk's states, and the C contraction is one batched product; the
whole scan runs inside a ``mamba.scan`` ``record_function`` range.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFModel
from ..ops import layers as L
from .config import ModelConfig
from .weights import _t, dequant_tensor, load_dense, load_linear

ARCHS = ("mamba",)


@dataclass
class MambaCache:
    """conv: (L, B, d_conv - 1, d_inner) float32 conv tails; ssm: (L, B,
    d_inner, d_state) float32 scan states. Written in place."""

    conv: torch.Tensor
    ssm: torch.Tensor

    # the tensors whose axis 1 is the batch (the server's row views)
    ROW_FIELDS = ("conv", "ssm")

    @property
    def capacity(self) -> int:
        return 1 << 30      # a recurrent state never fills

    @property
    def device(self) -> torch.device:
        return self.conv.device

    def zero_row(self, row: int) -> None:
        """Reset one batch row's state to a fresh sequence's."""
        self.conv[:, row].zero_()
        self.ssm[:, row].zero_()

    def checkpoint(self) -> tuple:
        """A copy of every row's conv tail and scan state, which a
        speculative verify may have to put back (the cache is written in
        place, so a reference would not do)."""
        return self.conv.clone(), self.ssm.clone()

    def restore(self, ckpt: tuple, row: int | None = None) -> None:
        """Put back a checkpoint's conv tails and scan states: every row's,
        or one batch row's."""
        conv, ssm = ckpt
        if row is None:
            self.conv.copy_(conv)
            self.ssm.copy_(ssm)
        else:
            self.conv[:, row] = conv[:, row]
            self.ssm[:, row] = ssm[:, row]

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, capacity: int = 0, device="cuda",
               quant=False):
        """A zeroed state for ``batch`` rows; ``capacity`` does not apply,
        and a KV cache type has no effect (logged), as in the JAX package."""
        if quant:
            logging.getLogger("ik_llama_cpp_tpu_torch").warning(
                "KV cache type %r has no effect on %s: it has no KV cache", quant, cfg.arch)
        d_inner = cfg.ssm_d_inner
        return cls(
            torch.zeros((cfg.n_layer, batch, cfg.ssm_d_conv - 1, d_inner),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layer, batch, d_inner, cfg.ssm_d_state),
                        dtype=torch.float32, device=device))


def load_mamba_params(gg: GGUFModel, cfg: ModelConfig, device, *,
                      use_quant: bool = True) -> dict:
    """GGUF -> nested dict of device tensors and linear modules, the JAX
    loader's tree. A and D are read under their bare names or with
    ``.weight``. Every ``blk.N.*`` tensor is consumed or refused."""
    t = gg.tensors
    used: set = set()

    def take(name: str):
        used.add(name)
        return t[name]

    def linear(name: str):
        return load_linear(take(name), device, use_quant=use_quant)

    def dense(name: str):
        return load_dense(take(name), device)

    params: dict = {
        "tok_embd": _t(dequant_tensor(take("token_embd.weight")), device, torch.bfloat16),
        "output_norm": dense("output_norm.weight"),
        "output": linear("output.weight" if "output.weight" in t else "token_embd.weight")}
    blocks = []
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        blocks.append({
            "attn_norm": dense(p + "attn_norm.weight"),
            "ssm_in": linear(p + "ssm_in.weight"),
            # depthwise conv kernel, logical (d_inner, 1, d_conv) -> (d_inner, d_conv)
            "conv1d": _t(dequant_tensor(take(p + "ssm_conv1d.weight")).reshape(
                cfg.ssm_d_inner, cfg.ssm_d_conv), device, torch.float32),
            "conv1d_b": dense(p + "ssm_conv1d.bias"),
            "ssm_x": linear(p + "ssm_x.weight"),
            "ssm_dt": linear(p + "ssm_dt.weight"),
            "ssm_dt_b": dense(p + "ssm_dt.bias"),
            "ssm_a": dense(p + "ssm_a.weight" if p + "ssm_a.weight" in t else p + "ssm_a"),
            "ssm_d": dense(p + "ssm_d.weight" if p + "ssm_d.weight" in t else p + "ssm_d"),
            "ssm_out": linear(p + "ssm_out.weight"),
        })
    for name in t:
        if name.startswith("blk.") and name not in used:
            raise NotImplementedError(
                f"tensor {name!r}: the {cfg.arch} graph does not apply it")
    params["blocks"] = blocks
    return params


def _valid_rows(n_valid: list, t: int, d_conv: int, device):
    """The padding rule of a chunk, made once a forward: each row's conv
    tail index (B, d_conv - 1), the d_conv - 1 inputs that end at its last
    valid position, and the live positions (B, T) bool, or None when every
    row's n_valid is T."""
    nv = torch.tensor(n_valid, dtype=torch.int64, device=device)
    tail = nv[:, None] + torch.arange(d_conv - 1, device=device)
    if all(n == t for n in n_valid):
        return tail, None
    return tail, torch.arange(t, device=device)[None, :] < nv[:, None]


def _selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, state: torch.Tensor, live) -> torch.Tensor:
    """x, dt: (B, T, d_inner) f32; A: (d_inner, d_state); B, C: (B, T,
    d_state) f32; live: (B, T) bool, or None when every position is. Writes
    the state after the chunk into ``state`` (B, d_inner, d_state) f32; a
    position that is not live leaves it bit for bit (its decay is 1 and its
    input 0). Returns y (B, T, d_inner) f32.

    Every operand of the recurrence is made for the whole chunk first:
    softplus(dt), the decay exp(dt' A) and the input B (x dt'). Each token
    is then one launch, state_t = input_t + state_{t-1} * decay_t, into a
    (T, B, d_inner, d_state) buffer of every state, and the contraction
    with C is one batched product over the chunk."""
    with torch.profiler.record_function("mamba.scan"):
        dt_sp = torch.nn.functional.softplus(dt)
        x_dt = x * dt_sp
        decay = torch.exp(dt_sp[..., None] * A)                  # (B, T, d_inner, d_state)
        if live is not None:
            x_dt = x_dt.masked_fill(~live[..., None], 0.0)
            decay = decay.masked_fill(~live[..., None, None], 1.0)
        inp = x_dt[..., None] * B[:, :, None, :]                 # (B, T, d_inner, d_state)
        states = torch.empty((x.shape[1],) + tuple(state.shape), dtype=torch.float32,
                             device=x.device)
        prev = state
        for d, u, out in zip(decay.unbind(1), inp.unbind(1), states.unbind(0)):
            torch.addcmul(u, prev, d, out=out)
            prev = out
        state.copy_(prev)
        ys = torch.matmul(states, C.transpose(0, 1)[..., None])  # (T, B, d_inner, 1)
        return ys[..., 0].transpose(0, 1)


def _mamba_block(blk: dict, x: torch.Tensor, cfg: ModelConfig, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, valid: tuple) -> torch.Tensor:
    """x: (B, T, E) normalized; valid: ``_valid_rows`` of the chunk. Writes
    the new conv tail and scan state into ``conv_state`` / ``ssm_state``
    (views of the cache) in place; positions past a row's n_valid leave
    both as they were. Returns the float32 output (B, T, E)."""
    b, t, _ = x.shape
    d_inner, d_conv = cfg.ssm_d_inner, cfg.ssm_d_conv
    d_state, dt_rank = cfg.ssm_d_state, cfg.ssm_dt_rank
    tail, live = valid

    xz = blk["ssm_in"](x)                                        # (B, T, 2 * d_inner)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]

    # causal depthwise conv with the carried tail (ggml_ssm_conv)
    xpad = torch.cat([conv_state, xs.float()], dim=1)            # (B, T + dc - 1, d_inner)
    w = blk["conv1d"]                                            # (d_inner, d_conv)
    y = xpad[:, 0:t] * w[:, 0]
    for k in range(1, d_conv):
        y = y + xpad[:, k:k + t] * w[:, k]
    # the conv tail ends at the last valid position
    conv_state.copy_(torch.gather(xpad, 1, tail[:, :, None].expand(-1, -1, d_inner)))
    y = y + blk["conv1d_b"]
    xcv = y * torch.sigmoid(y)                                   # silu

    # projections for dt, B, C
    xdb = blk["ssm_x"](xcv.to(torch.bfloat16))
    dt_low = xdb[..., :dt_rank]
    B_t = xdb[..., dt_rank:dt_rank + d_state].float()
    C_t = xdb[..., dt_rank + d_state:].float()
    dt = (blk["ssm_dt"](dt_low.to(torch.bfloat16)) + blk["ssm_dt_b"]).float()

    A = blk["ssm_a"].reshape(d_inner, d_state)                   # already -exp(A_log)
    D = blk["ssm_d"].reshape(d_inner)
    ys = _selective_scan(xcv, dt, A, B_t, C_t, ssm_state, live)

    ys = ys + xcv * D
    zf = z.float()
    ys = ys * (zf * torch.sigmoid(zf))
    return blk["ssm_out"](ys.to(torch.bfloat16))


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: MambaCache,
            n_past=0, *, npv: torch.Tensor | None = None, logits_last_only: bool = False,
            n_valid=None, return_hidden: bool = False,
            return_layer_hiddens: bool = False) -> torch.Tensor:
    """tokens: (B, T) on the cache's device. ``n_past`` and ``npv`` are not
    read (the state carries the history); n_valid: None (all T), an int, or
    one length a row (host ints) — the tokens of each row that the state
    takes. Writes the chunk into ``cache`` in place and returns the float32
    logits (B, T or 1, V); with ``return_hidden`` the final-norm hidden
    states (B, T, E) f32 instead, with ``return_layer_hiddens`` every
    layer's output (L, B, T, E) f32. The state takes the chunk either
    way."""
    b, t = tokens.shape
    dev = cache.device
    if n_valid is None:
        n_valid = t
    nv = [int(n_valid)] * b if np.ndim(n_valid) == 0 else [int(n) for n in n_valid]
    if len(nv) != b or not all(0 <= n <= t for n in nv):
        raise ValueError(f"n_valid {nv} outside [0, {t}] or not one a row of {b}")
    valid = _valid_rows(nv, t, cfg.ssm_d_conv, dev)
    x = params["tok_embd"][tokens]                               # (B, T, E) bf16
    layer_hiddens = []
    for i, blk in enumerate(params["blocks"]):
        h = L.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        y = _mamba_block(blk, h, cfg, cache.conv[i], cache.ssm[i], valid)
        x = x + y.to(x.dtype)
        if "cvec" in params:                   # control vector at the layer output
            x = x + params["cvec"][i].to(x.dtype)
        if return_layer_hiddens:
            layer_hiddens.append(x.float())
    if return_layer_hiddens:
        return torch.stack(layer_hiddens)
    x = L.rms_norm(x, params["output_norm"], cfg.rms_eps)
    if return_hidden:
        return x.float()
    if logits_last_only:
        x = x[:, -1:, :]
    return params["output"](x).float()
