"""GGUF v2/v3 reader — mmap-backed, zero-copy tensor access.

Re-expresses the contract of the reference reader (`gguf_init_from_file`,
ggml.c:30988): magic 'GGUF', version, tensor directory, typed KV metadata,
alignment-padded tensor data region. Tensor payloads are returned as numpy
views into the mmap, so loading a 100GB model does not copy bytes until a
tensor is actually materialized.

Also supports split GGUFs (model-00001-of-00003.gguf) the way the reference's
llama_model_loader does: metadata from the first shard, tensors unioned over
all shards.
"""
from __future__ import annotations

import mmap
import os
import re
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    row_bytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<?", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}

_NP_SCALAR = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # ggml order: ne[0] fastest-varying (row length first)
    ggml_type: GGMLType
    offset: int  # relative to data section start
    # filled by the reader:
    data: np.ndarray | None = None  # raw bytes view (uint8)

    @property
    def n_elements(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def n_bytes(self) -> int:
        n_per_row = self.shape[0]
        nrows = self.n_elements // n_per_row
        return row_bytes(self.ggml_type, n_per_row) * nrows


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, nbytes: int) -> bytes:
        out = bytes(self.buf[self.pos:self.pos + nbytes])
        if len(out) != nbytes:
            raise EOFError("truncated GGUF file")
        self.pos += nbytes
        return out

    def scalar(self, fmt: str, size: int):
        return struct.unpack(fmt, self.read(size))[0]

    def u32(self) -> int:
        return self.scalar("<I", 4)

    def u64(self) -> int:
        return self.scalar("<Q", 8)

    def string(self, version: int) -> str:
        n = self.u64() if version >= 2 else self.u32()
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType, version: int):
        if vtype == GGUFValueType.STRING:
            return self.string(version)
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self.u32())
            count = self.u64() if version >= 2 else self.u32()
            if etype in _NP_SCALAR:
                dt = np.dtype(_NP_SCALAR[etype]).newbyteorder("<")
                raw = self.read(count * dt.itemsize)
                return np.frombuffer(raw, dtype=dt, count=count)
            if etype == GGUFValueType.BOOL:
                raw = self.read(count)
                return np.frombuffer(raw, dtype=np.uint8).astype(bool)
            return [self.value(etype, version) for _ in range(count)]
        fmt, size = _SCALAR_FMT[vtype]
        return self.scalar(fmt, size)


class GGUFReader:
    """Reads one .gguf file. Use `load_gguf` for split-file support."""

    def __init__(self, path: str | os.PathLike, map_data: bool = True):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        if map_data:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            buf = memoryview(self._mm)
        else:
            buf = self._file.read()
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse(buf)

    def _parse(self, buf) -> None:
        cur = _Cursor(buf)
        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = cur.u64()
        n_kv = cur.u64()
        for _ in range(n_kv):
            key = cur.string(self.version)
            vtype = GGUFValueType(cur.u32())
            self.metadata[key] = cur.value(vtype, self.version)
        infos: list[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string(self.version)
            n_dims = cur.u32()
            shape = tuple(cur.u64() for _ in range(n_dims))
            ttype = GGMLType(cur.u32())
            offset = cur.u64()
            infos.append(GGUFTensorInfo(name, shape, ttype, offset))
        alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        data_start = (cur.pos + alignment - 1) // alignment * alignment
        arr = np.frombuffer(buf, dtype=np.uint8)
        for info in infos:
            start = data_start + info.offset
            info.data = arr[start:start + info.n_bytes]
            self.tensors[info.name] = info

    def close(self):
        try:
            self._mm.close()
        except Exception:
            pass
        self._file.close()


@dataclass
class GGUFModel:
    """Union of one or more GGUF shards: single metadata dict + all tensors."""

    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    paths: list[Path] = field(default_factory=list)
    _readers: list[GGUFReader] = field(default_factory=list)

    def tensor_names(self) -> Iterator[str]:
        return iter(self.tensors)

    def get(self, name: str) -> GGUFTensorInfo:
        return self.tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tensors


_SPLIT_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


def load_gguf(path: str | os.PathLike) -> GGUFModel:
    """Open a GGUF model, following -00001-of-000NN split naming if present."""
    path = Path(path)
    paths = [path]
    m = _SPLIT_RE.match(path.name)
    if m:
        base, _idx, total = m.group(1), int(m.group(2)), int(m.group(3))
        paths = [path.parent / f"{base}-{i:05d}-of-{total:05d}.gguf" for i in range(1, total + 1)]
    readers = [GGUFReader(p) for p in paths]
    metadata = dict(readers[0].metadata)
    tensors: dict[str, GGUFTensorInfo] = {}
    for r in readers:
        tensors.update(r.tensors)
    return GGUFModel(metadata=metadata, tensors=tensors, paths=paths, _readers=readers)
