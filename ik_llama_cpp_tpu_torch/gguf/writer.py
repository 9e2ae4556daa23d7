"""GGUF v3 writer.

Counterpart to gguf-py's GGUFWriter (reference: gguf-py/gguf/gguf_writer.py
behavior; binary layout per ggml.c gguf_write_to_file). Used by the quantize
tool, the HF converter, and the test suite (synthetic model fixtures).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

from .constants import GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC, GGMLType, GGUFValueType, row_bytes


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw


def _value_type_of(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if iv < 0:
            return GGUFValueType.INT64 if iv < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if iv >= 2**32 else GGUFValueType.UINT32
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VT = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _pack_value(v: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_str(v)
    if vtype == GGUFValueType.ARRAY:
        if isinstance(v, np.ndarray) and v.dtype in _NP_TO_VT:
            et = _NP_TO_VT[v.dtype]
            body = np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IQ", int(et), v.size) + body
        items = list(v)
        if not items:
            return struct.pack("<IQ", int(GGUFValueType.INT32), 0)
        et = _value_type_of(items[0])
        if et == GGUFValueType.ARRAY:
            raise TypeError("nested GGUF arrays unsupported")
        body = b"".join(_pack_value(it, et) for it in items)
        return struct.pack("<IQ", int(et), len(items)) + body
    return struct.pack(_SCALAR_PACK[vtype], v)


_F_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int8): GGMLType.I8,
}


class GGUFWriter:
    def __init__(self, path: str | Path, arch: str | None = None):
        self.path = Path(path)
        self.kv: dict[str, Any] = {}
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []
        if arch is not None:
            self.add("general.architecture", arch)

    def add(self, key: str, value: Any) -> None:
        self.kv[key] = value

    def add_tensor(
        self,
        name: str,
        data: np.ndarray | bytes,
        *,
        shape: tuple[int, ...] | None = None,
        ggml_type: GGMLType | None = None,
    ) -> None:
        """Add a tensor.

        For float/int arrays: pass numpy data in *row-major logical shape*
        (e.g. (n_out, n_in) for a weight) and it is stored with ggml
        dims reversed (ne[0] = n_in = row length), matching the reference
        converter's behavior.
        For pre-quantized payloads: pass raw bytes + explicit shape
        (ggml order) + ggml_type.
        """
        if isinstance(data, np.ndarray) and ggml_type is None:
            ggml_type = _F_GGML[data.dtype]
            shape = tuple(reversed(data.shape))  # ggml ne order
            payload = np.ascontiguousarray(data).tobytes()
        else:
            assert shape is not None and ggml_type is not None
            payload = bytes(data)
            n_per_row = shape[0]
            nrows = 1
            for s in shape[1:]:
                nrows *= s
            expect = row_bytes(ggml_type, n_per_row) * nrows
            assert len(payload) == expect, (name, len(payload), expect)
        self._tensors.append((name, shape, ggml_type, payload))

    def write(self) -> None:
        align = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        out = bytearray()
        out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self.kv))
        for key, value in self.kv.items():
            vtype = _value_type_of(value)
            out += _pack_str(key)
            out += struct.pack("<I", int(vtype))
            out += _pack_value(value, vtype)
        # tensor directory with running aligned offsets
        offset = 0
        dir_entries = []
        data_blobs = []
        for name, shape, ttype, payload in self._tensors:
            dir_entries.append((name, shape, ttype, offset))
            data_blobs.append(payload)
            size = len(payload)
            offset += (size + align - 1) // align * align
        for name, shape, ttype, off in dir_entries:
            out += _pack_str(name)
            out += struct.pack("<I", len(shape))
            for s in shape:
                out += struct.pack("<Q", s)
            out += struct.pack("<IQ", int(ttype), off)
        pad = (-len(out)) % align
        out += b"\x00" * pad
        for blob in data_blobs:
            out += blob
            out += b"\x00" * ((-len(blob)) % align)
        self.path.write_bytes(bytes(out))
