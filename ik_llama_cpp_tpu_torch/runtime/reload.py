"""On-demand tensor reload — the analogue of the reference's llama-reload
(src/llama-reload.cpp, llama_reload_changed_tensors @ include/llama.h:1635):
pick up tensors that changed on disk (an overwritten / re-quantized /
finetune-patched GGUF) into the live model without restarting.

The torch port of the JAX package's ``runtime/reload.py``. Changed tensors
are found by the file's mtime, then by per-tensor CRCs of the data bytes.
A changed tensor that maps onto one leaf of the llama-family tree is
re-encoded the way the load encoded it (``models/weights.load_linear``: for
``QLinearI8`` the supergroup recode on the load's device) and copied into
the live leaf's storage in place, so every holder of the module sees the
new weights; anything else (a fused projection, a bitnet-scaled linear,
expert stacks, embeddings, another family) takes a full loader pass.
"""
from __future__ import annotations

import os
import zlib

import torch

# GGUF blk.N.<suffix> -> llama-family param key (models/llama.py loader)
_BLK_KEY = {
    "attn_q.weight": ("wq", "linear"),
    "attn_k.weight": ("wk", "linear"),
    "attn_v.weight": ("wv", "linear"),
    "attn_qkv.weight": ("wqkv", "linear"),
    "attn_output.weight": ("wo", "linear"),
    "ffn_gate.weight": ("ffn_gate", "linear"),
    "ffn_up.weight": ("ffn_up", "linear"),
    "ffn_down.weight": ("ffn_down", "linear"),
    "attn_norm.weight": ("attn_norm", "dense"),
    "ffn_norm.weight": ("ffn_norm", "dense"),
}
_TOP_KEY = {
    "output.weight": ("output", "linear"),
    "output_norm.weight": ("output_norm", "dense"),
}


def _crc(info) -> int:
    return zlib.crc32(info.data)


class ReloadInfo:
    """Per-tensor source bookkeeping (reference tensor_reload_source:
    path/offset/nbytes/mtime, llama-reload-info.h:16-49)."""

    def __init__(self, path: str, gg):
        self.path = str(path)
        self.mtime_ns = os.stat(self.path).st_mtime_ns
        self.crcs = {name: _crc(ti) for name, ti in gg.tensors.items()}

    def file_changed(self) -> bool:
        try:
            return os.stat(self.path).st_mtime_ns != self.mtime_ns
        except OSError:
            return False

    def changed_tensors(self, new_gg) -> list[str]:
        return [name for name, ti in new_gg.tensors.items()
                if self.crcs.get(name) != _crc(ti)]


def _swap(holder: dict, key: str, new) -> None:
    """Put ``new`` in ``holder[key]``: copied into the old leaf's storage
    where every buffer matches in shape and dtype, else in its place."""
    old = holder[key]
    if isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor):
        if old.shape == new.shape and old.dtype == new.dtype:
            old.copy_(new)
            return
    elif type(old) is type(new) and isinstance(old, torch.nn.Module):
        ob, nb = dict(old.named_buffers()), dict(new.named_buffers())
        if ob.keys() == nb.keys() and all(
                ob[k].shape == nb[k].shape and ob[k].dtype == nb[k].dtype for k in ob) \
                and vars(old).get("group") == vars(new).get("group"):
            for k in ob:
                ob[k].copy_(nb[k])
            return
    holder[key] = new


def _target(rt, new_gg, name: str):
    """(the dict that holds ``name``'s leaf, its key, "linear" | "dense"),
    or None where the tensor has no leaf of its own to patch."""
    from ..models import llama as llama_mod
    if rt.cfg.arch not in llama_mod.ARCHS:
        return None
    if name in _TOP_KEY:
        key, kind = _TOP_KEY[name]
        return (rt.params, key, kind) if key in rt.params else None
    if not name.startswith("blk."):
        return None
    _, il, suffix = name.split(".", 2)
    hit = _BLK_KEY.get(suffix)
    blocks = rt.params.get("blocks", [])
    if hit is None or int(il) >= len(blocks):
        return None
    key, kind = hit
    blk = blocks[int(il)]
    base = name[:-len(".weight")]
    if key not in blk or base + ".scale" in new_gg.tensors:
        return None           # fused away, or a bitnet scale folded in at load
    if key == "ffn_up" and "ffn_gate" not in blk and f"blk.{il}.ffn_gate.weight" in new_gg.tensors:
        return None           # ffn_up holds the fused gate|up
    if type(blk[key]).__name__ == "LoraLinear":
        return None           # an adapter wraps it: the full pass rebuilds the base
    return blk, key, kind


def reload_changed_tensors(rt) -> bool:
    """Re-read tensors whose on-disk bytes changed into ``rt.params``.

    Returns True if anything was reloaded. Requires the runtime to have
    been created with ``track_reload=True`` (which records per-tensor CRCs
    at load time, the analogue of snapshot_all_reload_tensors)."""
    info: ReloadInfo | None = getattr(rt, "_reload_info", None)
    if info is None:
        raise RuntimeError("runtime was not created with track_reload=True")
    if not info.file_changed():
        return False

    from ..gguf.reader import load_gguf
    from ..models.weights import load_dense, load_linear
    from .generate import LOADERS

    new_gg = load_gguf(info.path)
    changed = info.changed_tensors(new_gg)
    st = os.stat(info.path)
    if not changed:
        info.mtime_ns = st.st_mtime_ns
        return False
    use_quant = rt._loader_kw.get("use_quant", True)
    patches, full_reload = [], False
    for name in changed:
        hit = _target(rt, new_gg, name)
        if hit is None:
            full_reload = True
            break
        holder, key, kind = hit
        t = new_gg.tensors[name]
        patches.append((holder, key, load_linear(t, rt.device, use_quant=use_quant)
                        if kind == "linear" else load_dense(t, rt.device)))
    if full_reload:
        # an unmapped tensor: rebuild the whole tree (the reference's
        # FALLBACK path, still without restarting the process)
        rt.params = LOADERS[rt.cfg.arch](new_gg, rt.cfg, rt.device, **rt._loader_kw)
    else:
        for holder, key, new in patches:
            _swap(holder, key, new)
    info.crcs = {name: _crc(ti) for name, ti in new_gg.tensors.items()}
    info.mtime_ns = st.st_mtime_ns
    return True
