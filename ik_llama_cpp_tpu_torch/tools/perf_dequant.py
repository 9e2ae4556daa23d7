"""Decode-path dequant-matmul microbenchmark on the card.

The torch counterpart of the JAX package's ``tools/perf_dequant.py``: times
the planar dequant-matmul variants at the decode shape (M = 16, K = 4096,
N = 14336 by default) with CUDA events, the L2 cache flushed before each
call, and prints microseconds a product and GB/s of weight bytes streamed.

    python -m ik_llama_cpp_tpu_torch.tools.perf_dequant [--m 16] [--reps 20]

Variants:
  int8-f32s    the planar kernel (``ops/qmatmul.qmatmul``), f32 scales
  int8-bf16s   the same kernel, bf16 scales (the same numbers: the kernel
               rounds f32 scales to bf16)
  int16-pair   two codes a 16-bit lane: codes packed (K, N/2) int16, the
               low / high output half in the low / high byte
               (``qmatmul_pair``)
  torch-bf16   ``torch.matmul`` on the dequantized bf16 weight (no dequant
               in the product: the yardstick)
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..ops import _cuda
from ..ops.qmatmul import _dequant_bf16, _gemv_operand, _launch_plan, qmatmul, qmatmul_ref


def pack_pairs(codes: np.ndarray) -> np.ndarray:
    """int8 (K, N) -> int16 (K, N/2): low byte = cols [0, N/2), high byte =
    cols [N/2, N)."""
    n = codes.shape[1]
    lo = codes[:, : n // 2].astype(np.uint8).astype(np.uint16)
    hi = codes[:, n // 2:].astype(np.uint8).astype(np.uint16)
    return (lo | (hi << 8)).astype(np.uint16).view(np.int16)


def unpack_pairs(codes16: torch.Tensor) -> torch.Tensor:
    """int16 (K, N/2) -> the int8 (K, N) codes ``pack_pairs`` packed."""
    v = codes16.to(torch.int32)
    lo = ((v & 0xFF) ^ 0x80) - 0x80                 # sign-extended low byte
    return torch.cat([lo, v >> 8], dim=1).to(torch.int8)


def qmatmul_pair_ref(x, codes16, scale, *, group: int = 32):
    """Plain version: ``qmatmul_ref`` on the unpacked codes."""
    return qmatmul_ref(x, unpack_pairs(codes16), scale, group=group)


def qmatmul_pair(x, codes16, scale, *, group: int = 32):
    """x (M, K) @ packed int16 codes (K, N/2) -> f32 (M, N); scale f32 or
    bf16 (K/group, N). Output column j comes from the low byte of packed
    column j, column j + N/2 from its high byte.

    CUDA kernels of ``csrc/qmatmul.cu`` (their pair form), which replace
    the Pallas kernel tools/perf_dequant.py:qmatmul_pair of the JAX
    package: the planar kernels' arithmetic, split plan and order of sums
    behind a loader whose 16-byte load is 8 packed columns, both halves
    (above 16 rows: the wgmma kernel's tile of 128 code bytes, 64 packed
    columns and their high halves), so the result equals ``qmatmul`` on
    the unpacked codes bit for bit. Bound by the weight bytes at the decode
    shape (M <= 16)."""
    if x.device.type == "cpu":
        return qmatmul_pair_ref(x, codes16, scale, group=group)
    m, k = x.shape
    k2, nh = codes16.shape
    n = 2 * nh
    _cuda.require(k == k2 and k % group == 0,
                  f"qmatmul_pair: shapes {tuple(x.shape)} {tuple(codes16.shape)} group {group}")
    _cuda.require(codes16.dtype == torch.int16 and codes16.is_contiguous(),
                  "qmatmul_pair: codes must be contiguous int16")
    _cuda.require(scale.dtype in (torch.bfloat16, torch.float32) and scale.is_contiguous()
                  and scale.shape == (k // group, n),
                  "qmatmul_pair: scale must be contiguous bf16 or float32 (K/group, N)")
    for t in (codes16, scale):
        _cuda.require(t.device == x.device, "qmatmul_pair: operands on different devices")
    splits, tile_m = _launch_plan(m, n, k, group, x)
    xb = _gemv_operand(x, codes16, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("qmatmul", "ik_qmatmul_pair",
                        [_cuda.P] * 3 + [_cuda.I, _cuda.P] + [_cuda.I] * 6 + [_cuda.P])
    rc = fn(xb.data_ptr(), codes16.data_ptr(), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), out.data_ptr(), m, n, k, group, splits,
            tile_m, _cuda.stream_ptr(x))
    qmatmul_pair.launches += 1
    _cuda.check(rc, "qmatmul_pair")
    return out


qmatmul_pair.launches = 0      # kernel launches, counted where they happen


def _time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median CUDA-event time of fn, the L2 cache flushed before each rep
    and the card kept busy while the host enqueues."""
    fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=14336)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default="int8-f32s,int8-bf16s,int16-pair,torch-bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_dequant times kernels on the card: CUDA is not available")
    m, k, n, g = args.m, args.k, args.n, args.group
    rng = np.random.default_rng(0)
    codes_np = rng.integers(-127, 128, (k, n), dtype=np.int8)
    codes = torch.from_numpy(codes_np).cuda()
    scale = torch.from_numpy((rng.standard_normal((k // g, n)) * 0.01).astype(np.float32)).cuda()
    scale_bf = scale.to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda().to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    print(f"{torch.cuda.get_device_name(0)}: M={m} K={k} N={n} group={g}")
    gb = k * n / 1e9                        # int8 code bytes per product
    results = {}
    for variant in args.variants.split(","):
        if variant == "int8-f32s":
            fn = lambda: qmatmul(x, codes, scale, group=g)             # noqa: E731
        elif variant == "int8-bf16s":
            fn = lambda: qmatmul(x, codes, scale_bf, group=g)          # noqa: E731
        elif variant == "int16-pair":
            packed = torch.from_numpy(pack_pairs(codes_np)).cuda()
            fn = lambda: qmatmul_pair(x, packed, scale_bf, group=g)    # noqa: E731
        elif variant == "torch-bf16":
            dense = _dequant_bf16(codes, scale_bf, None, g)
            fn = lambda: torch.matmul(x, dense)                        # noqa: E731
        else:
            raise SystemExit(f"unknown variant {variant}")
        ms = _time_ms(fn, args.reps, flush)
        streamed = gb if variant != "torch-bf16" else 2 * gb
        results[variant] = (ms * 1e3, streamed / (ms * 1e-3))
        print(f"{variant:12s}  {ms * 1e3:8.1f} us/matmul   "
              f"{streamed / (ms * 1e-3):7.1f} GB/s streamed   "
              f"({gb / (ms * 1e-3):7.1f} G weights/s)")
    return results


if __name__ == "__main__":
    main()
