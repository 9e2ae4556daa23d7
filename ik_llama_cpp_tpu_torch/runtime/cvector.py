"""Control vectors (activation steering): load, apply, remove, write.

The torch counterpart of the JAX package's ``runtime/cvector.py``. The GGUF
format is the reference cvector-generator's output: ``general.architecture
= "controlvector"`` and one f32 tensor ``direction.<il>`` of n_embd values
per steered layer, 1-indexed (``direction.1`` steers layer 0).

Applied, each layer's output gains ``scale * direction[il]``
(llama_control_vector::apply_to at the l_out hook of every reference
graph): ``models/llama.forward`` adds ``params["cvec"][il]`` there. The
generator (PCA or mean of hidden-state differences) needs the runtime's
per-layer hidden states, a later slice (ROADMAP.md §1 item 7).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..gguf.reader import load_gguf
from ..gguf.writer import GGUFWriter
from ..models.weights import dequant_tensor


def load_control_vector(path: str | Path, n_layer: int, n_embd: int, *,
                        scale: float = 1.0, layer_start: int = 0,
                        layer_end: int = -1) -> np.ndarray:
    """A dense (n_layer, n_embd) f32 array, zero outside the steered layers
    [layer_start, layer_end) (llama_control_vector_load semantics)."""
    gg = load_gguf(path)
    out = np.zeros((n_layer, n_embd), np.float32)
    if layer_end < 0:
        layer_end = n_layer
    for name, info in gg.tensors.items():
        if not name.startswith("direction."):
            continue
        idx = int(name.split(".")[1]) - 1      # direction tensors are 1-indexed
        if 0 <= idx < n_layer and layer_start <= idx < layer_end:
            out[idx] = dequant_tensor(info).reshape(-1)[:n_embd] * scale
    return out


def apply_control_vector(params: dict, cvec: np.ndarray, device) -> dict:
    """Put the (n_layer, n_embd) steering array into ``params`` on
    ``device``, where the forward adds it to each layer's output."""
    params["cvec"] = torch.as_tensor(np.asarray(cvec, np.float32), device=device)
    return params


def remove_control_vector(params: dict) -> dict:
    params.pop("cvec", None)
    return params


def write_control_vector(path: str | Path, directions: np.ndarray) -> Path:
    """directions: (n_layer, n_embd); layer il is stored as direction.(il+1)
    and all-zero layers are left out."""
    w = GGUFWriter(path, arch="controlvector")
    for il, d in enumerate(directions):
        if np.any(d != 0):
            w.add_tensor(f"direction.{il + 1}", d.astype(np.float32))
    w.write()
    return Path(path)
