"""LoRA adapters: load, apply, rescale, strip, merge, write.

The torch counterpart of the JAX package's ``runtime/lora.py``. The GGUF
adapter format is the reference's convert_lora_to_gguf.py output:
``general.type = "adapter"``, ``adapter.type = "lora"``,
``adapter.lora.alpha`` (f32), and per target tensor a pair
``<base-name>.lora_a`` (ne = (n_in, r)) / ``<base-name>.lora_b``
(ne = (r, n_out)).

Application is the runtime low-rank form (llm_build_lora_mm semantics):
the quantized base weights stay as they are, on their kernel, and each
adapted linear gains a ``scale * (x @ A^T) @ B^T`` term
(``models/weights.LoraLinear``). ``merge_lora`` is the export-lora
analogue: dequantize, add the delta, write F16.

One difference by design: the JAX ``apply_lora`` skips an adapter tensor
that matches no linear of the model (``attn_q`` on a model whose q/k/v
were fused at load); the port's raises, as its loaders refuse tensors they
do not consume. Load the model with ``fuse=False`` to adapt q/k/v or
gate/up apart.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import load_gguf
from ..gguf.writer import GGUFWriter
from ..models.weights import LoraLinear, dequant_tensor
from ..quant.quantize import quantize

# maps param-dict keys (models/llama.py) to GGUF tensor names
_BLK_KEY_TO_NAME = {
    "wq": "attn_q.weight",
    "wk": "attn_k.weight",
    "wv": "attn_v.weight",
    "wqkv": "attn_qkv.weight",
    "wo": "attn_output.weight",
    "ffn_gate": "ffn_gate.weight",
    "ffn_up": "ffn_up.weight",
    "ffn_down": "ffn_down.weight",
}


@dataclass
class LoraAdapter:
    """One loaded adapter: target tensor name -> (A (r, n_in), B (n_out, r))."""
    path: str
    alpha: float
    tensors: dict[str, tuple[np.ndarray, np.ndarray]]
    scale: float = 1.0      # user scale multiplier

    @property
    def rank(self) -> int:
        if not self.tensors:
            return 0
        a, _ = next(iter(self.tensors.values()))
        return a.shape[0]

    def effective_scale(self) -> float:
        r = self.rank or 1
        return self.scale * (self.alpha / r if self.alpha > 0 else 1.0)


def load_lora_gguf(path: str | Path) -> LoraAdapter:
    gg = load_gguf(path)
    md = gg.metadata
    if str(md.get("general.type", "")) not in ("adapter", ""):
        raise ValueError(f"{path}: not an adapter GGUF")
    alpha = float(np.asarray(md.get("adapter.lora.alpha", 0.0)))
    pairs: dict[str, dict[str, np.ndarray]] = {}
    for name, info in gg.tensors.items():
        if name.endswith(".lora_a"):
            base, part = name[: -len(".lora_a")], "a"
        elif name.endswith(".lora_b"):
            base, part = name[: -len(".lora_b")], "b"
        else:
            continue
        pairs.setdefault(base, {})[part] = dequant_tensor(info)
    tensors = {}
    for base, ab in pairs.items():
        if "a" in ab and "b" in ab:
            tensors[base] = (ab["a"].astype(np.float32), ab["b"].astype(np.float32))
    return LoraAdapter(path=str(path), alpha=alpha, tensors=tensors)


def _device_of(linear) -> torch.device:
    return next(linear.buffers()).device


def _wrap(linear, a: np.ndarray, b: np.ndarray, scale: float) -> LoraLinear:
    # the linears are (K = n_in, N = n_out): delta^T = A^T @ B^T
    dev = _device_of(linear)
    a_t = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev, torch.bfloat16)   # (n_in, r)
    b_t = torch.from_numpy(np.ascontiguousarray(b.T)).to(dev, torch.bfloat16)   # (r, n_out)
    base = linear.base if isinstance(linear, LoraLinear) else linear
    return LoraLinear(base, a_t, b_t, torch.tensor(scale, dtype=torch.float32, device=dev))


def apply_lora(params: dict, adapter: LoraAdapter) -> dict:
    """Wrap every adapted linear in params with a LoraLinear (a linear that
    already carries an adapter gets the new one in its place). Returns the
    same dict (mutated). Raises ValueError, before changing anything, when
    an adapter tensor matches no linear of the model."""
    s = adapter.effective_scale()
    targets = []
    if "output" in params:
        targets.append((params, "output", "output.weight"))
    for i, blk in enumerate(params["blocks"]):
        for key, suffix in _BLK_KEY_TO_NAME.items():
            if key in blk:
                targets.append((blk, key, f"blk.{i}.{suffix}"))
    hit = [(d, key, name) for d, key, name in targets if name in adapter.tensors]
    unused = sorted(set(adapter.tensors) - {name for _, _, name in hit})
    if unused:
        raise ValueError(
            f"{adapter.path}: {len(unused)} adapter tensor(s) match no linear of the "
            f"model, e.g. {unused[:4]}; load the model with fuse=False to adapt "
            "q/k/v or gate/up apart")
    for d, key, name in hit:
        a, b = adapter.tensors[name]
        d[key] = _wrap(d[key], a, b, s)
    return params


def _lora_slots(params: dict):
    """(dict, key) of every LoraLinear in params."""
    if isinstance(params.get("output"), LoraLinear):
        yield params, "output"
    for blk in params["blocks"]:
        for key in list(blk):
            if isinstance(blk[key], LoraLinear):
                yield blk, key


def strip_lora(params: dict) -> dict:
    """Remove every LoraLinear wrapper (restore the base linears)."""
    for d, key in list(_lora_slots(params)):
        d[key] = d[key].base
    return params


def set_lora_scale(params: dict, scale: float, adapter: LoraAdapter) -> None:
    """Rescale the applied adapters in place (POST /lora-adapters
    semantics): only each wrapper's 0-d scale tensor is written."""
    adapter.scale = scale
    s = adapter.effective_scale()
    for d, key in _lora_slots(params):
        d[key].scale.fill_(s)


def merge_lora(base_path: str | Path, lora_path: str | Path,
               out_path: str | Path, *, scale: float = 1.0) -> Path:
    """export-lora analogue: merge the adapter into a base GGUF, writing the
    adapted tensors as F16 (examples/export-lora/export-lora.cpp)."""
    gg = load_gguf(base_path)
    adapter = load_lora_gguf(lora_path)
    adapter.scale = scale
    s = adapter.effective_scale()

    arch = str(gg.metadata["general.architecture"])
    w = GGUFWriter(out_path, arch=arch)
    for key, val in gg.metadata.items():
        if key == "general.architecture":
            continue
        w.add(key, val)
    for name, info in gg.tensors.items():
        if name in adapter.tensors:
            a, b = adapter.tensors[name]
            dense = dequant_tensor(info)            # logical (n_out, n_in)
            delta = (b @ a) * s
            merged = (dense.reshape(delta.shape) + delta).astype(np.float32)
            w.add_tensor(name, quantize(merged, GGMLType.F16),
                         shape=tuple(reversed(merged.shape)),
                         ggml_type=GGMLType.F16)
        else:
            w.add_tensor(name, info.data, shape=info.shape,
                         ggml_type=info.ggml_type)
    w.write()
    return Path(out_path)


def write_lora_gguf(path: str | Path, arch: str, alpha: float,
                    tensors: dict[str, tuple[np.ndarray, np.ndarray]]) -> Path:
    """Write a LoRA adapter GGUF (convert_lora_to_gguf.py output format)."""
    w = GGUFWriter(path, arch=arch)
    w.add("general.type", "adapter")
    w.add("adapter.type", "lora")
    w.add("adapter.lora.alpha", float(alpha))
    for base, (a, b) in tensors.items():
        w.add_tensor(base + ".lora_a", a.astype(np.float32))
        w.add_tensor(base + ".lora_b", b.astype(np.float32))
    w.write()
    return Path(path)
