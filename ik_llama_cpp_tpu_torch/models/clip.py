"""CLIP/SigLIP vision encoder and whisper audio encoder with their
multimodal projectors — the analogue of examples/mtmd/clip.cpp.

The torch counterpart of the JAX package's ``models/clip.py``. It loads
mmproj GGUF files (``clip.vision.*`` / ``clip.audio.*`` metadata, ``v.*`` /
``a.*`` tensors, ``mm.*`` projectors; names per examples/mtmd/clip-impl.h):

  * vision: a pre-LN ViT with an optional class token, learned position
    embeddings and a quickgelu or tanh-gelu MLP, then a projector (llava's
    MLP ``mm.0``/``mm.2``, gemma3's ``mm.input_projection``, idefics3's
    ``mm.model.fc``) into the text model's embedding space; the class token
    is dropped before the projector;
  * audio: whisper's encoder (two conv1d layers with gelu_erf, the blocks,
    the avgpool of qwen2a and voxtral, ``post_ln``, StackAudioFrames) and
    the ultravox, qwen2a or voxtral projector.

Weights are float32, as in the JAX package, and every product runs in full
float32 (``_full_f32``: no TF32). The two convolutions are written as
patch matrices times the kernel, so no cuDNN convolution (TF32 by default
on the card) is involved. The attention is one float32
``scaled_dot_product_attention`` call, as in ``models/bert.py``. None of
this reaches a Pallas kernel in the JAX package: its products are plain
XLA, and here plain ``torch.matmul``.

``preprocess_image`` resizes with the port's own bicubic filter
(``resize_bicubic``), which reproduces PIL's ``Image.BICUBIC`` resample of
8-bit images (a = -0.5, the support widened by the scale when shrinking,
22-bit fixed-point weights, a horizontal then a vertical pass with uint8
rounding between them), so no PIL is needed.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFModel, load_gguf
from .weights import _t as _to_device
from .weights import dequant_tensor


@dataclass(frozen=True)
class ClipConfig:
    image_size: int
    patch_size: int
    n_embd: int
    n_head: int
    n_ff: int
    n_layer: int
    eps: float
    proj_dim: int
    projector_type: str
    use_gelu: bool          # False = quickgelu (CLIP default)
    image_mean: tuple
    image_std: tuple
    has_class_embd: bool = True


def _get(md, key, default=None):
    v = md.get(key, default)
    if hasattr(v, "item"):
        v = v.item()
    return v


def clip_config_from_gguf(md: dict) -> ClipConfig:
    g = lambda k, d=None: _get(md, f"clip.vision.{k}", d)  # noqa: E731
    mean = md.get("clip.vision.image_mean", [0.48145466, 0.4578275, 0.40821073])
    std = md.get("clip.vision.image_std", [0.26862954, 0.26130258, 0.27577711])
    return ClipConfig(
        image_size=int(g("image_size", 224)),
        patch_size=int(g("patch_size", 14)),
        n_embd=int(g("embedding_length")),
        n_head=int(g("attention.head_count")),
        n_ff=int(g("feed_forward_length")),
        n_layer=int(g("block_count")),
        eps=float(g("attention.layer_norm_epsilon", 1e-5)),
        proj_dim=int(g("projection_dim", 0)),
        projector_type=str(_get(md, "clip.projector_type", "mlp")),
        use_gelu=bool(_get(md, "clip.use_gelu", False)),
        image_mean=tuple(float(x) for x in np.asarray(mean).reshape(-1)),
        image_std=tuple(float(x) for x in np.asarray(std).reshape(-1)),
    )


def _loader(gg: GGUFModel, device):
    def f32(name: str) -> torch.Tensor:
        return _to_device(dequant_tensor(gg.tensors[name]), device, torch.float32)
    return f32


def _blocks(gg: GGUFModel, n_layer: int, pre: str, f32) -> list:
    """The encoder blocks' weights, (in, out) float32, biases where the
    file has them, and the two LayerNorms as (weight, bias)."""
    t = gg.tensors
    blocks = []
    for i in range(n_layer):
        b: dict[str, Any] = {}
        for key, tn in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                        ("wo", "attn_out"), ("ffn_up", "ffn_up"), ("ffn_down", "ffn_down")):
            b[key] = f32(f"{pre}.blk.{i}.{tn}.weight").T.contiguous()
            if f"{pre}.blk.{i}.{tn}.bias" in t:
                b[key + "_b"] = f32(f"{pre}.blk.{i}.{tn}.bias")
        for key in ("ln1", "ln2"):
            b[key] = (f32(f"{pre}.blk.{i}.{key}.weight"), f32(f"{pre}.blk.{i}.{key}.bias"))
        blocks.append(b)
    return blocks


def load_clip_params(gg: GGUFModel, cfg: ClipConfig, device) -> dict:
    """The vision tower and its projector as the JAX loader's tree, float32
    tensors on ``device``: the patch conv (E, 3, ps, ps), linears (in, out)."""
    t = gg.tensors
    f32 = _loader(gg, device)
    p: dict[str, Any] = {}
    pe = dequant_tensor(t["v.patch_embd.weight"])
    p["patch_w"] = _to_device(pe.reshape(cfg.n_embd, 3, cfg.patch_size, cfg.patch_size),
                              device, torch.float32)
    if "v.patch_embd.bias" in t:
        p["patch_b"] = f32("v.patch_embd.bias")
    if "v.class_embd" in t:
        p["class_embd"] = f32("v.class_embd")
    p["pos_embd"] = f32("v.position_embd.weight")
    for pre in ("pre_ln", "post_ln"):
        if f"v.{pre}.weight" in t:
            p[pre] = (f32(f"v.{pre}.weight"), f32(f"v.{pre}.bias"))
    p["blocks"] = _blocks(gg, cfg.n_layer, "v", f32)
    # projector variants (clip-impl.h TN_LLAVA_PROJ / TN_MM_INP_PROJ / TN_MM_PROJECTOR)
    if "mm.0.weight" in t:
        p["proj"] = [(f32("mm.0.weight").T.contiguous(), f32("mm.0.bias"))]
        if "mm.2.weight" in t:
            p["proj"].append((f32("mm.2.weight").T.contiguous(), f32("mm.2.bias")))
    elif "mm.input_projection.weight" in t:
        p["proj"] = [(f32("mm.input_projection.weight").T.contiguous(), None)]
    elif "mm.model.fc.weight" in t:
        p["proj"] = [(f32("mm.model.fc.weight").T.contiguous(), None)]
    else:
        p["proj"] = []
    return p


@contextlib.contextmanager
def _full_f32():
    """Float32 products in full float32 (no TF32) inside the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _quickgelu(x):
    return x * torch.sigmoid(1.702 * x)


def _linear(x, b: dict, key: str):
    y = x @ b[key]
    return y + b[key + "_b"] if key + "_b" in b else y


def _encoder_block(x, b: dict, n_head: int, eps: float, act):
    """One pre-LN block: x + attn(LN1(x)), then + FFN(LN2(x))."""
    n, e = x.shape
    d = e // n_head
    y = _layer_norm(x, *b["ln1"], eps)
    q, k, v = (_linear(y, b, w).reshape(n, n_head, d).transpose(0, 1)[None]
               for w in ("wq", "wk", "wv"))
    y = F.scaled_dot_product_attention(q, k, v)[0].transpose(0, 1).reshape(n, e)
    x = x + _linear(y, b, "wo")
    y = _layer_norm(x, *b["ln2"], eps)
    return x + _linear(act(_linear(y, b, "ffn_up")), b, "ffn_down")


def clip_forward(p: dict, cfg: ClipConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (3, H, W) float32 normalized. Returns (n_tokens, proj_dim)."""
    ps = cfg.patch_size
    n_side = cfg.image_size // ps
    with _full_f32():
        # the patch conv as a product: each patch's (3, ps, ps) values
        # against the kernel's, patches in row-major order
        patches = (pixels[:, :n_side * ps, :n_side * ps]
                   .reshape(3, n_side, ps, n_side, ps).permute(1, 3, 0, 2, 4)
                   .reshape(n_side * n_side, 3 * ps * ps))
        x = patches @ p["patch_w"].reshape(cfg.n_embd, -1).T     # (P, E)
        if "patch_b" in p:
            x = x + p["patch_b"]
        if "class_embd" in p:
            x = torch.cat([p["class_embd"][None], x], dim=0)
        x = x + p["pos_embd"][: x.shape[0]]
        if "pre_ln" in p:
            x = _layer_norm(x, *p["pre_ln"], cfg.eps)
        act = (lambda y: F.gelu(y, approximate="tanh")) if cfg.use_gelu else _quickgelu
        for b in p["blocks"]:
            x = _encoder_block(x, b, cfg.n_head, cfg.eps, act)
        if "post_ln" in p:
            x = _layer_norm(x, *p["post_ln"], cfg.eps)
        if "class_embd" in p:       # the llava projector drops the class token
            x = x[1:]
        for i, (w, bias) in enumerate(p["proj"]):
            x = x @ w
            if bias is not None:
                x = x + bias
            if i + 1 < len(p["proj"]):
                x = F.gelu(x)
    return x


# -------------------------------------------------------------- bicubic --
_PRECISION_BITS = 32 - 8 - 2        # PIL's fixed point for 8-bit resampling


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter: each output pixel's first input pixel, and its ksize
    fixed-point weights (zero past the window)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / fscale)
        ww = w.sum()
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        first[xx] = xmin
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * one), np.trunc(0.5 + kk * one))
    return first, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of an (H, W, C)
    uint8 array, rounded to uint8."""
    in_size = img.shape[axis]
    first, k = _coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(k.shape[1])[None], in_size - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)     # (.., out, ksize, ..)
    shape = [1] * src.ndim
    shape[axis], shape[axis + 1] = k.shape
    ss = (src * k.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """An (H, W, 3) uint8 image resized to (height, width) as PIL's
    ``Image.resize((width, height), Image.BICUBIC)`` does it."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.shape[1] != width:
        rgb = _resample_axis(rgb, width, 1)
    if rgb.shape[0] != height:
        rgb = _resample_axis(rgb, height, 0)
    return rgb


def preprocess_image(img, cfg: ClipConfig) -> np.ndarray:
    """(H, W, 3) uint8 array (or a PIL image) -> normalized (3, S, S) f32
    (clip_image_preprocess: bicubic resize + mean/std normalize)."""
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    arr = resize_bicubic(img, cfg.image_size, cfg.image_size).astype(np.float32) / 255.0
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1)


class ClipEncoder(torch.nn.Module):
    """A loaded mmproj's vision tower on ``device``: ``encode`` turns an
    image into text-embedding-space rows, (P, E_text) float32 on the
    device."""

    def __init__(self, path, device):
        super().__init__()
        gg = load_gguf(path)
        self.device = torch.device(device)
        self.cfg = clip_config_from_gguf(gg.metadata)
        self.params = load_clip_params(gg, self.cfg, self.device)

    @property
    def n_patch_tokens(self) -> int:
        return (self.cfg.image_size // self.cfg.patch_size) ** 2

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return clip_forward(self.params, self.cfg, pixels)

    def encode(self, img) -> torch.Tensor:
        px = torch.from_numpy(np.ascontiguousarray(preprocess_image(img, self.cfg)))
        return self(px.to(self.device))


# ---------------------------------------------------------------------------
# Whisper-style audio encoder (clip.cpp build_whisper_enc)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AudioConfig:
    """``clip.audio.*`` hparams (clip.cpp load_hparams, is_audio branch)."""
    n_mel: int
    n_embd: int
    n_head: int
    n_ff: int
    n_layer: int
    eps: float
    proj_dim: int
    projector_type: str      # ultravox | qwen2a | voxtral
    stack_factor: int        # ultravox/voxtral StackAudioFrames
    ffn_op: str              # gelu | silu | gelu_quick (KEY_USE_GELU/SILU)


def audio_config_from_gguf(md: dict) -> AudioConfig:
    g = lambda k, d=None: _get(md, f"clip.audio.{k}", d)  # noqa: E731
    # audio projectors (ultravox/qwen2a/voxtral) force FFN_GELU_ERF
    # regardless of clip.use_gelu/use_silu (clip.cpp:3412)
    return AudioConfig(
        n_mel=int(g("num_mel_bins", 128)),
        n_embd=int(g("embedding_length")),
        n_head=int(g("attention.head_count")),
        n_ff=int(g("feed_forward_length")),
        n_layer=int(g("block_count")),
        eps=float(g("attention.layer_norm_epsilon", 1e-5)),
        proj_dim=int(g("projection_dim", 0)),
        projector_type=str(_get(md, "clip.audio.projector_type",
                                _get(md, "clip.projector_type", "qwen2a"))),
        stack_factor=int(g("projector.stack_factor", 0)),
        ffn_op="gelu_erf",
    )


def load_audio_params(gg: GGUFModel, cfg: AudioConfig, device) -> dict:
    """``a.*`` tensors and the audio projector (clip.cpp load_tensors
    PROJECTOR_TYPE_ULTRAVOX/QWEN2A/VOXTRAL cases) as the JAX loader's tree,
    float32 tensors on ``device``."""
    t = gg.tensors
    f32 = _loader(gg, device)
    p: dict[str, Any] = {}
    for i in (1, 2):
        # conv1d weights: ggml ne (kernel, in_ch, out_ch) -> (out, in, k)
        p[f"conv{i}_w"] = f32(f"a.conv1d.{i}.weight")
        p[f"conv{i}_b"] = f32(f"a.conv1d.{i}.bias").reshape(-1)
    p["pos_embd"] = f32("a.position_embd.weight")
    if "a.post_ln.weight" in t:
        p["post_ln"] = (f32("a.post_ln.weight"), f32("a.post_ln.bias"))
    p["blocks"] = _blocks(gg, cfg.n_layer, "a", f32)
    pt = cfg.projector_type
    if pt == "ultravox":
        p["mm_norm_pre"] = f32("mm.a.norm_pre.weight")
        p["mm_norm_mid"] = f32("mm.a.norm_mid.weight")
        p["mm_1"] = f32("mm.a.mlp.1.weight").T.contiguous()
        p["mm_2"] = f32("mm.a.mlp.2.weight").T.contiguous()
    elif pt == "qwen2a":
        p["mm_fc"] = f32("mm.a.fc.weight").T.contiguous()
        p["mm_fc_b"] = f32("mm.a.fc.bias")
    elif pt == "voxtral":
        p["mm_1"] = f32("mm.a.mlp.1.weight").T.contiguous()
        p["mm_2"] = f32("mm.a.mlp.2.weight").T.contiguous()
    else:
        raise ValueError(f"unknown audio projector type {pt!r}")
    return p


_FFN_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_erf": F.gelu,
    "gelu_quick": _quickgelu,
    "silu": F.silu,
}


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """(C_in, T) through a kernel (C_out, C_in, k) with 'same' padding of
    one and ``stride``, as a product of the (T_out, C_in k) patches."""
    k = w.shape[2]
    cols = F.pad(x, (1, 1)).unfold(1, k, stride)                # (C_in, T_out, k)
    cols = cols.permute(1, 0, 2).reshape(cols.shape[1], -1)
    return (cols @ w.reshape(w.shape[0], -1).T).T + b[:, None]


def rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def whisper_forward(p: dict, cfg: AudioConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (n_mel, n_frames) normalized log-mel chunk -> (n_tokens,
    proj_dim) embeddings (clip.cpp build_whisper_enc: conv1d x2 + gelu_erf,
    ViT, optional avgpool/frame-stacking, audio projector)."""
    with _full_f32():
        x = F.gelu(_conv1d(mel, p["conv1_w"], p["conv1_b"], 1))
        x = F.gelu(_conv1d(x, p["conv2_w"], p["conv2_b"], 2))
        x = x.T                                                 # (n_pos, E)
        x = x + p["pos_embd"][: x.shape[0]]
        act = _FFN_ACTS[cfg.ffn_op]
        for b in p["blocks"]:
            x = _encoder_block(x, b, cfg.n_head, cfg.eps, act)
        if cfg.projector_type in ("qwen2a", "voxtral"):         # audio_has_avgpool
            n2 = (x.shape[0] // 2) * 2
            x = x[:n2].reshape(n2 // 2, 2, cfg.n_embd).mean(dim=1)
        if "post_ln" in p:
            x = _layer_norm(x, *p["post_ln"], cfg.eps)
        if cfg.projector_type in ("ultravox", "voxtral") and cfg.stack_factor:
            # StackAudioFrames: flatten row-major, zero-pad to a multiple of
            # n_embd * stack_factor, regroup
            stride = cfg.n_embd * cfg.stack_factor
            flat = x.reshape(-1)
            x = F.pad(flat, (0, (-flat.shape[0]) % stride)).reshape(-1, stride)
        pt = cfg.projector_type
        if pt == "ultravox":
            x = rms(x) * p["mm_norm_pre"]
            x = x @ p["mm_1"]
            a, bb = torch.chunk(x, 2, dim=-1)
            x = a * F.silu(bb)                  # swiglu_swapped: silu(2nd half)
            x = rms(x) * p["mm_norm_mid"]
            x = x @ p["mm_2"]
        elif pt == "qwen2a":
            x = x @ p["mm_fc"] + p["mm_fc_b"]
        else:                                   # voxtral
            x = F.gelu(x @ p["mm_1"]) @ p["mm_2"]
    return x


class AudioEncoder(torch.nn.Module):
    """A loaded audio mmproj on ``device``: ``encode`` turns 16 kHz mono
    samples into text-embedding-space rows (every 3000-frame chunk's,
    concatenated), float32 on the device."""

    def __init__(self, path, device):
        super().__init__()
        gg = load_gguf(path)
        if not _get(gg.metadata, "clip.has_audio_encoder", False):
            raise ValueError(f"{path} has no audio encoder")
        self.device = torch.device(device)
        self.cfg = audio_config_from_gguf(gg.metadata)
        self.params = load_audio_params(gg, self.cfg, self.device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return whisper_forward(self.params, self.cfg, mel)

    def encode(self, samples: np.ndarray) -> torch.Tensor:
        from ..runtime.mtmd_audio import preprocess_audio
        chunks = preprocess_audio(np.asarray(samples, np.float32))
        if not chunks:
            raise ValueError("audio shorter than one hop")
        return torch.cat([self(torch.from_numpy(c).to(self.device)) for c in chunks], dim=0)
