"""Control vectors (activation steering): load, apply, remove, write.

The torch counterpart of the JAX package's ``runtime/cvector.py``. The GGUF
format is the reference cvector-generator's output: ``general.architecture
= "controlvector"`` and one f32 tensor ``direction.<il>`` of n_embd values
per steered layer, 1-indexed (``direction.1`` steers layer 0).

Applied, each layer's output gains ``scale * direction[il]``
(llama_control_vector::apply_to at the l_out hook of every reference
graph): ``models/llama.forward`` adds ``params["cvec"][il]`` there.

Generation (``generate_control_vector``, cvector-generator's pca and mean
modes): each layer's direction from the differences of the last token's
hidden state (``Runtime.layer_hiddens``) between paired positive and
negative prompts.
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


def generate_control_vector(runtime, positive: list[str], negative: list[str], *,
                            method: str = "pca") -> np.ndarray:
    """The cvector-generator: for each layer, the principal direction
    (``method`` "pca": the first right singular vector of the centred
    differences, oriented along their mean; one pair or "mean": the mean)
    of the (positive - negative) differences of the last token's output,
    normalized. Returns (n_layer, n_embd) float32; the SVD runs in numpy
    on the host, as in the JAX package."""
    cfg = runtime.cfg
    diffs = [[] for _ in range(cfg.n_layer)]
    for pos, neg in zip(positive, negative):
        hp = runtime.layer_hiddens(runtime.tokenizer.encode(pos))[:, -1].cpu().numpy()
        hn = runtime.layer_hiddens(runtime.tokenizer.encode(neg))[:, -1].cpu().numpy()
        for il in range(cfg.n_layer):
            diffs[il].append(hp[il] - hn[il])
    out = np.zeros((cfg.n_layer, cfg.n_embd), np.float32)
    for il in range(cfg.n_layer):
        d = np.stack(diffs[il])                  # (n_pairs, E)
        if method == "mean" or d.shape[0] == 1:
            v = d.mean(axis=0)
        else:
            dc = d - d.mean(axis=0, keepdims=True)
            _, _, vt = np.linalg.svd(dc, full_matrices=False)
            v = vt[0]
            if np.dot(v, d.mean(axis=0)) < 0:    # orient along the mean difference
                v = -v
        n = np.linalg.norm(v)
        if n > 0:
            out[il] = v / n
    return out
