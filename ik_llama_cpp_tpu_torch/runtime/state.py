"""Session state save/restore — the analogue of llama_state_* (llama.h:961-1040)
and the server's /slots save/restore.

The torch port of the JAX package's ``runtime/state.py``. A state file
holds (tokens, n_past, the cache's rows [0, n_past)) in the JAX package's
``IKTPUST1`` format, so a file written by either package loads in the
other:

    MAGIC | u32 meta length | meta JSON | one record an array

with meta ``{"tokens", "n_past", "quantized", "k_dtype", "capacity"}`` and
each record ``u32 ndim | i64 shape[ndim] | u32 len | numpy dtype string |
raw bytes``, little-endian: k and v, then k_scale and v_scale for a
quantized cache (q8 and the packed codecs). bf16 rows are written and read
as raw 16-bit words (dtype string ``<V2``, numpy's for ml_dtypes'
bfloat16), through a torch view: numpy has no bfloat16.

A writer may add ``"rows_exact": true`` to the meta: every one of the
n_past rows was written (the port's engine and CLI do). The JAX engine
saves a slot whose last token has no row yet, and writes no such key.

Only a ``KVCache`` with both k and v is taken. Every other cache raises,
naming its type: ``MixedKVCache`` (per-layer codecs), ``SwaKVCache``
(rings), the MLA latent ``KVCache`` with v None, the recurrent
``HybridCache`` and ``MambaCache``, the encoder's ``NoCache``.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..models.llama import KVCache

MAGIC = b"IKTPUST1"
BF16 = "<V2"                 # numpy's dtype string of ml_dtypes' bfloat16


def _check_cache(kv) -> None:
    if type(kv) is not KVCache or kv.v is None:
        what = type(kv).__name__ + (" with v None (the MLA latent cache)"
                                    if type(kv) is KVCache else "")
        raise TypeError(f"a state file holds a KVCache's k/v rows; the {what} "
                        "has no such layout")


def _dtype_name(t: torch.Tensor) -> str:
    """The cache dtype as the JAX package's ``str(dtype)`` spells it."""
    return str(t.dtype).removeprefix("torch.")


def _host_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's bytes as a numpy array and the record's dtype string."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    a = t.numpy()
    return a, a.dtype.str


def save_state(path, tokens: list[int], n_past: int, kv: KVCache, *,
               rows_exact: bool = False) -> int:
    """Write (tokens, n_past, kv's rows [0, n_past) on the S axis) to
    ``path``; returns the file's size in bytes."""
    _check_cache(kv)
    meta = {
        "tokens": list(map(int, tokens)),
        "n_past": int(n_past),
        "quantized": kv.quantized,
        "k_dtype": _dtype_name(kv.k),
        "capacity": int(kv.capacity),
    }
    if rows_exact:
        meta["rows_exact"] = True
    mb = json.dumps(meta).encode()
    arrays = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(mb)))
        f.write(mb)
        for arr in arrays:
            a, dt = _host_array(arr[:, :, :n_past])
            f.write(struct.pack("<I", a.ndim))
            f.write(struct.pack(f"<{a.ndim}q", *a.shape))
            f.write(struct.pack("<I", len(dt)))
            f.write(dt.encode())
            f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        return f.tell()


def read_state_meta(path) -> dict | None:
    """The header (tokens, n_past, capacity, ...) of a state file without
    its rows — the server's saved-prompt listing. None if the file is not
    a state file."""
    try:
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                return None
            (mlen,) = struct.unpack("<I", f.read(4))
            if mlen > 1 << 24:
                return None
            return json.loads(f.read(mlen))
    except (OSError, ValueError, struct.error):
        return None


def _read_array(f) -> torch.Tensor:
    (nd,) = struct.unpack("<I", f.read(4))
    shape = struct.unpack(f"<{nd}q", f.read(8 * nd))
    (dl,) = struct.unpack("<I", f.read(4))
    dts = f.read(dl).decode()
    bf16 = dts == BF16 or "bfloat16" in dts
    dt = np.dtype(np.int16) if bf16 else np.dtype(dts)
    a = np.empty(shape, dt)
    if f.readinto(a.reshape(-1).view(np.uint8)) != a.nbytes:
        raise ValueError("state file ends inside an array")
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def load_state(path, kv: KVCache):
    """Write a state file's rows into ``kv`` in place, rows [0, n_past) of
    its S axis; the rows above stay as they were. Returns (tokens, n_past,
    kv). The file's arrays must have kv's dtypes and, but for the S axis,
    its shape."""
    _check_cache(kv)
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path} is not a state file")
        (mlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(mlen))
        n_past = int(meta["n_past"])
        if meta["quantized"] != kv.quantized:
            kind = lambda q: "quantized" if q else "bf16"
            raise ValueError(f"the state file's cache is {kind(meta['quantized'])}, "
                             f"this one {kind(kv.quantized)}")
        if kv.capacity < n_past:
            raise ValueError(f"cache too small for the saved state: {kv.capacity} rows, "
                             f"{n_past} saved")
        dests = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])
        for dst in dests:
            src = _read_array(f)
            view = dst[:, :, :n_past]
            if src.dtype != dst.dtype or tuple(src.shape) != tuple(view.shape):
                raise ValueError(f"state file array {src.dtype} {tuple(src.shape)} does not "
                                 f"fit the cache's {dst.dtype} {tuple(view.shape)}")
            view.copy_(src)
    return meta["tokens"], n_past, kv


def restored_tokens(meta: dict) -> list[int]:
    """The tokens whose rows a state file holds: the first n_past of its
    list, less the last one unless the writer marked every row written
    (the JAX engine saves a slot's last emitted token, whose row it never
    wrote)."""
    n = int(meta["n_past"])
    toks = list(meta["tokens"][:n])
    return toks if meta.get("rows_exact") else toks[:n - 1]
