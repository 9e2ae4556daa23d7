"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root, then loaded with ``ctypes``.
Sources build in parallel (one ``nvcc`` process each). A library's file name
carries a hash of its source and of the shared header, so an edited kernel
is rebuilt and an unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("qmatmul_i8", "qmatmul", "qmatmul4", "flash_attention",
           "flash_attention_decode", "flash_attention_decode_q",
           "flash_attention_q8", "moe_decode_i8", "moe_qmm_i8", "moe_decode",
           "moe_decode_fused_i8", "moe_qmm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, *, ptxas_verbose: bool = False) -> dict:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once. Returns {name: (seconds, compiler output)} for the
    ones it built; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                     else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, text)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``; the first use builds every
    library not built yet, in parallel."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def function(lib: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``lib``, with its argtypes."""
    key = (lib, symbol)
    if key not in _fns:
        fn = getattr(load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(rc: int, what: str) -> None:
    if rc != 0:
        lib = next(iter(_libs.values()))
        lib.ik_error_string.restype = ctypes.c_char_p
        lib.ik_error_string.argtypes = [ctypes.c_int]
        msg = lib.ik_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The current stream of t's device, which must be the current device:
    the C entry points launch on the current device's context."""
    import torch
    require(t.device.index in (None, torch.cuda.current_device()),
            f"tensor on {t.device}, current device cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def aligned16(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
