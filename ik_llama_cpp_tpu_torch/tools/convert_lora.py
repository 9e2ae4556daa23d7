"""HF PEFT LoRA adapter -> GGUF adapter converter.

The torch counterpart of the JAX package's ``tools/convert_lora.py`` (the
analogue of the reference's convert_lora_to_gguf.py): reads
``adapter_config.json`` and ``adapter_model.safetensors`` (or ``.bin``) and
writes a GGUF with ``general.type = adapter`` and ``.lora_a`` / ``.lora_b``
tensor pairs named after the base model's GGUF tensors.

The safetensors file is read by a small reader of its own
(``read_safetensors``), so that no ``safetensors`` package is needed: an
8-byte little-endian header length, a JSON header of name -> dtype, shape
and byte offsets, then the raw little-endian data. A ``.bin`` is read with
``torch.load(weights_only=True)``.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.convert_lora <peft_dir> -o adapter.gguf \\
      [--arch llama]
"""
from __future__ import annotations

import argparse
import json
import re
import struct
from pathlib import Path

import numpy as np

from ..runtime.lora import write_lora_gguf

# HF module -> GGUF tensor-name fragment (convert_lora_to_gguf's tensor map)
_HF_TO_GGUF = {
    "self_attn.q_proj": "attn_q.weight",
    "self_attn.k_proj": "attn_k.weight",
    "self_attn.v_proj": "attn_v.weight",
    "self_attn.o_proj": "attn_output.weight",
    "self_attn.qkv_proj": "attn_qkv.weight",
    "mlp.gate_proj": "ffn_gate.weight",
    "mlp.up_proj": "ffn_up.weight",
    "mlp.down_proj": "ffn_down.weight",
    "mlp.gate_up_proj": "ffn_up.weight",
    "lm_head": "output.weight",
}

_LAYER_RE = re.compile(r"layers\.(\d+)\.(.+?)\.lora_(A|B)\.weight$")
_HEAD_RE = re.compile(r"(lm_head)\.lora_(A|B)\.weight$")

# safetensors float dtype -> numpy little-endian dtype (BF16 is widened by hand)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array (BF16 widened to
    float32 exactly, the other float types as stored); a tensor of another
    dtype raises."""
    buf = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = meta["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dt}, not a float type")
        lo, hi = meta["data_offsets"]
        a = np.frombuffer(buf, dtype=_ST_DTYPES[dt], count=(hi - lo) // np.dtype(
            _ST_DTYPES[dt]).itemsize, offset=base + lo)
        if dt == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.reshape(meta["shape"]).copy()
    return out


def _load_state_dict(peft_dir: Path) -> dict[str, np.ndarray]:
    st_path = peft_dir / "adapter_model.safetensors"
    if st_path.exists():
        return {k: v.astype(np.float32) for k, v in read_safetensors(st_path).items()}
    bin_path = peft_dir / "adapter_model.bin"
    if bin_path.exists():
        import torch
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no adapter_model.[safetensors|bin] in {peft_dir}")


def convert_peft_dir(peft_dir: str | Path, out_path: str | Path,
                     arch: str = "llama") -> Path:
    peft_dir = Path(peft_dir)
    cfg = json.loads((peft_dir / "adapter_config.json").read_text())
    alpha = float(cfg.get("lora_alpha", cfg.get("alpha", 0.0)))
    sd = _load_state_dict(peft_dir)

    pairs: dict[str, dict[str, np.ndarray]] = {}
    for key, arr in sd.items():
        m = _LAYER_RE.search(key)
        if m:
            il, module, part = int(m.group(1)), m.group(2), m.group(3)
            frag = _HF_TO_GGUF.get(module)
            if frag is None:
                continue
            name = f"blk.{il}.{frag}"
        else:
            m = _HEAD_RE.search(key)
            if not m:
                continue
            name, part = "output.weight", m.group(2)
        pairs.setdefault(name, {})[part.lower()] = np.asarray(arr, np.float32)

    tensors = {}
    for name, ab in pairs.items():
        if "a" in ab and "b" in ab:
            tensors[name] = (ab["a"], ab["b"])    # A (r, n_in), B (n_out, r)
    if not tensors:
        raise ValueError("no LoRA tensor pairs found in adapter")
    return write_lora_gguf(out_path, arch, alpha, tensors)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ik_llama_cpp_tpu_torch.tools.convert_lora")
    ap.add_argument("peft_dir")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--arch", default="llama")
    args = ap.parse_args(argv)
    p = convert_peft_dir(args.peft_dir, args.out, args.arch)
    print(f"wrote {p}")


if __name__ == "__main__":
    main()
