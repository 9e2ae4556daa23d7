#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11,12,13,14,15]

Phases (all by default; any failure exits non-zero):
  1. device: the card's name and power limit; TF32 off for the plain versions
  2. build: every kernel under ik_llama_cpp_tpu_torch/csrc with nvcc
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with its error, tolerance, time, the plain
     version's time, a library call's time and the card's bound
  4. end to end at full width (L32 E4096 H32 KV8 FF14336 V32000, Q4_0
     planar weights, Q8_0 tied head, random weights from a seed): load
     through Runtime.from_gguf, prefill 512 tokens, decode 64 greedily,
     with every kernel launch counted; then a torch.profiler view of 8
     more decode steps (device time by kernel, busy share)
  5. parity at depth 2: kernel path against the plain path on the card,
     identical greedy tokens over 16 steps
  6. planar path: int8 path off, depth 2, the planar kernel must launch
  7. MoE end to end at the full width of Qwen3-30B-A3B (L48 E2048 H32 KV4
     D128, 128 experts top-8 FF768, V151936; Q4_0 attention and experts,
     Q8_0 embedding and untied head, random blocks from a seed): load,
     prefill 512, decode 64, with every kernel launch counted, then the
     decode profile
  8. MoE parity at depth 2: kernel path against the plain path on the card
  9. quantized KV cache end to end at the full width of phase 4: q8 (prefill
     512, decode 64, launch counts, decode profile), then q4, q6, nl4, q8
     with the K/V Hadamard rotation and a per-layer codec dict on the same
     weights, and one K-shift on the q8 cache followed by more decode steps
 10. quantized-KV parity at depth 2: per codec, kernel path against plain
     path over one token history (the plain path is fed the kernel path's
     greedy tokens): logits at every step, where the greedy picks differ,
     and the cache codes the two wrote
 11. 4-bit packed weights (set_pack_int4) at full width: every block linear
     a QLinearI4, prefill 512, decode 64, launch counts, parity at depth 2
 12. planar / mixed-format MoE end to end at the full width of
     Qwen1.5-MoE-A2.7B (qwen2moe: L24 E2048 H16 KV16 D128, q/k/v biases, 60
     experts top-4 FF1408, a shared expert of FF5632 with a sigmoid gate,
     V151936; Q4_0 attention, experts and shared expert, Q8_0 embedding and
     untied head, random blocks from a seed): gate/up experts re-coded per
     supergroup of 256, down experts planar group 32 (1408 % 256 != 0);
     load, prefill 512, decode 64, launch counts, decode and prefill profiles
 13. parity at depth 2, kernel path against plain path over one token
     history, for (a) the phase-12 model, (b) the Qwen3-30B-A3B shape with
     the int8 path off (every expert projection planar) and (c) the same
     shape with the single-kernel decode (IK_MOE_FUSED_TG=1)
 14. the single-kernel MoE decode at the full width of Qwen3-30B-A3B
     (IK_MOE_FUSED_TG=1 on phase 7's loaded model): decode 64, launch
     counts, the kernel time a step beside phase 7's two-kernel step
 15. the dequant microbenchmark tool (tools/perf_dequant) at its default
     shape: the planar GEMM with f32 and bf16 scales, its pair form, and a
     bf16 torch.matmul
The line before the last lists every ported kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core ops/s
BF16_FLOPS = 989e12        # dense bf16 tensor-core flop/s
E, H, HKV, FF, V, NL = 4096, 32, 8, 14336, 32000, 32
D = E // H
PREFILL, DECODE = 512, 64
GGUF_VERSION = "port-1"
# Qwen3-30B-A3B (the published config.json of Qwen/Qwen3-30B-A3B)
MOE = dict(ARCH="qwen3moe", L=48, E=2048, H=32, HKV=4, D=128, G=128, TOPK=8, FF=768,
           V=151936)
MOE_GGUF_VERSION = "port-4"
# Qwen1.5-MoE-A2.7B (the published config.json of Qwen/Qwen1.5-MoE-A2.7B):
# 1408 % 256 != 0, so its down experts stay planar beside supergroup gate/up
Q2MOE = dict(ARCH="qwen2moe", L=24, E=2048, H=16, HKV=16, D=128, G=60, TOPK=4, FF=1408,
             FFS=5632, V=151936)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- timing --
class Timer:
    """Median of CUDA-event times. Before each rep the L2 cache is flushed,
    so that weights are read from device memory as on the main path, and
    the card is kept busy for about half a millisecond while the host
    enqueues the timed call, so that host launch overhead stays out of a
    kernel's time (a plain version whose many launches outlast that still
    shows its host gaps)."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int | None = None) -> float:
        torch = self.torch
        fn()                                    # warm (and first-launch) run
        ts = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------- phases --
def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"[1] device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] plain versions in full float32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return {"name": name, "smi": line}


def phase_build(_cuda) -> None:
    t0 = time.perf_counter()
    built = _cuda.build(ptxas_verbose=True)
    log(f"[2] build: {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc, sm_90a)")
    for name, (_, text) in built.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln.lower() and "0 bytes spill" not in ln:
                log(f"    {name}: {ln.strip()}")


def _record(results, kernel, case, err, tol, ms, plain_ms, lib_ms, bnd, note=""):
    ok = err <= tol
    log(f"    {kernel} {case}: max_abs_err {err:.3e} tol {tol:.3e} "
        f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'} "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}){note}")
    results.setdefault(kernel, []).append(dict(
        case=case, err=err, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1]))
    return ok


def phase_kernels(torch, timer, results) -> bool:
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    shapes = [(E, (H + 2 * HKV) * D), (E, E), (E, 2 * FF), (FF, E), (E, V)]

    log("[3] kernel A (qmatmul_i8) vs plain; library = dense bf16 torch.matmul "
        "at the same (M, K, N), a yardstick, not the same function")
    for k, n in shapes:
        codes_t = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                                dtype=torch.int8)
        sw = torch.rand((k // 256, n), generator=gen, device="cuda") * 1e-3
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        for m in (1, 8, 512):
            x = torch.randn((m, k), generator=gen, device="cuda")
            xq, xs = QM.quantize_activations(x)
            got = QM.qmatmul_i8(xq, xs, codes_t.t(), sw)
            ref = QM.qmatmul_i8_ref(xq, xs, codes_t.t(), sw)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max()) + 1e-6
            xb = x.to(torch.bfloat16)
            nsg = k // 256
            bnd = bound_ms(m * k + m * nsg * 4 + k * n + nsg * n * 4 + m * n * 4,
                           2.0 * m * n * k, INT8_OPS)
            ok &= _record(results, "qmatmul_i8", f"M={m} K={k} N={n}", err, tol,
                          timer(lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw)),
                          timer(lambda: QM.qmatmul_i8_ref(xq, xs, codes_t.t(), sw), 3),
                          timer(lambda: torch.matmul(xb, wb)), bnd)
        del codes_t, wb

    log("[3] kernel D (qmatmul, planar group 32) vs plain; library as for A")
    for i, (k, n) in enumerate(shapes):
        codes = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
        scale = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02
                 ).to(torch.bfloat16)
        bias = None
        if i == 0:
            bias = (torch.randn((k // 32, n), generator=gen, device="cuda") * 0.01
                    ).to(torch.bfloat16)
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        for m in (1, 8, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            got = QM.qmatmul(x, codes, scale, bias)
            ref = QM.qmatmul_ref(x, codes, scale, bias)
            absdot = float((x.float().abs() @ QM._dequant_bf16(
                codes, scale, bias, 32).float().abs()).max())
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            # both sum the same exact bf16 products in float32 in different
            # orders: 16 sqrt(K) float32 roundings of the largest sum of |x w|
            tol = 16 * k ** 0.5 * 2.0 ** -24 * absdot
            nb = 2 if bias is not None else 1
            bnd = bound_ms(m * k * 2 + k * n + nb * (k // 32) * n * 2 + m * n * 4,
                           2.0 * m * n * k, BF16_FLOPS)
            ok &= _record(results, "qmatmul", f"M={m} K={k} N={n}"
                          + (" bias" if bias is not None else ""), err, tol,
                          timer(lambda: QM.qmatmul(x, codes, scale, bias)),
                          timer(lambda: QM.qmatmul_ref(x, codes, scale, bias), 3),
                          timer(lambda: torch.matmul(x, wb)), bnd)
        del codes, wb

    scale_ = 1.0 / float(np.sqrt(D))

    def attn_case(kernel, fn, b, t, s, qpos, kvlen, H=H, HKV=HKV):
        q = torch.randn((b, t, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        kc = torch.randn((b, s, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn((b, s, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        got = fn(q, kc, vc, qp, kl, scale=scale_)
        ref = FA.attention_ref(q, kc, vc, qp, kl, scale=scale_)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        # p is rounded to bf16 before the PV product and the output is bf16:
        # two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        # library: SDPA on the live rows with an explicit mask (not timed:
        # the mask, the GQA repeat)
        pos = torch.arange(s, device="cuda")
        qpos_t = qp[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos_t[:, :, None]) & \
            (pos[None, None, :] < kl[:, None, None])
        kr = kc.repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        vr = vc.repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        qt = q.transpose(1, 2)
        m4 = mask[:, None]
        lib = timer(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4,
                                                           scale=scale_))
        live = int(mask.sum())               # (query, key) pairs this run needs
        keys = sum(min(kvlen[i], qpos[i] + t) for i in range(b))
        bnd = bound_ms(2 * (b * t * H * D * 2) + 2 * keys * HKV * D * 2,
                       4.0 * H * D * live, BF16_FLOPS)
        case = (f"B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen}"
                + ("" if (H, HKV) == (32, 8) else f" H={H} HKV={HKV}"))
        return _record(results, kernel, case, err, tol,
                       timer(lambda: fn(q, kc, vc, qp, kl, scale=scale_)),
                       timer(lambda: FA.attention_ref(q, kc, vc, qp, kl,
                                                      scale=scale_), 3),
                       lib, bnd)

    log("[3] kernel B (flash_attention, prefill) vs plain; library = SDPA")
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [0], [512])
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [256], [768])
    log("[3] kernel C (flash_attention_decode) vs plain; library = SDPA")
    for t in (1, 8):
        for s, kvls in ((1024, (1, 513)), (4096, (1, 513, 4000))):
            for kvl in kvls:
                ok &= attn_case("flash_attention_decode", FA.flash_attention_decode,
                                1, t, s, [max(kvl - t, 0)], [kvl])
        ok &= attn_case("flash_attention_decode", FA.flash_attention_decode,
                        2, t, 1024, [513 - t, 1000 - t], [513, 1000])
    # no grouped queries (Qwen1.5-MoE-A2.7B): one query row per KV head
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, 1, 1024,
                    [512], [513], H=Q2MOE["H"], HKV=Q2MOE["HKV"])
    return ok


def phase_moe_kernels(torch, timer, results, c=MOE, dev="cuda") -> bool:
    """Kernels 7-10 against their plain versions at the MoE path's shapes
    (128 experts, E 2048, FF 768). Library yardsticks are bf16 torch.bmm /
    torch.matmul calls over the same rows and gathered expert weights: a
    comparable, heavier function, not the same one."""
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    g_, e_, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)

    def codes(n, k):          # (G, K, N) view of a contiguous (G, N, K) tensor
        return torch.randint(-127, 128, (g_, n, k), generator=gen, device=dev,
                             dtype=torch.int8).transpose(1, 2)

    def scales(k, n):
        return torch.rand((g_, k // 256, n), generator=gen, device=dev) * 2e-3 + 1e-5

    gate, up, down = codes(ff, e_), codes(ff, e_), codes(e_, ff)
    gsw, usw, dsw = scales(e_, ff), scales(e_, ff), scales(ff, e_)
    nsg, nsgf = e_ // 256, ff // 256
    ok = True

    log("[3] kernels 7/8 (moe_decode_gate_up_i8 / moe_decode_down_i8) vs plain; "
        "library = bf16 torch.bmm over the gathered pairs' gate|up / down")
    for t in (1, 8):
        p = t * topk
        ids = torch.from_numpy(np.concatenate([rng.permutation(g_)[:topk] for _ in range(t)])
                               .astype(np.int32)).to(dev)
        nd = len(set(ids.tolist()))               # distinct experts this run reads
        x = torch.randn((p, e_), generator=gen, device=dev)
        xq, xs = quantize_activations(x)
        a7 = (xq, xs.t(), ids, gate, gsw, up, usw)
        got, ref = MD.moe_decode_gate_up_i8(*a7), MD.moe_decode_gate_up_i8_ref(*a7)
        sync(torch)
        err = float((got.float() - ref.float()).abs().max())
        # h is bf16: two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        bnd = bound_ms(p * e_ + p * nsg * 4 + p * 4 + nd * (2 * e_ * ff + 2 * nsg * ff * 4)
                       + p * ff * 2, 4.0 * p * e_ * ff, INT8_OPS)
        li = ids.long()
        wb = torch.cat([gate[li], up[li]], dim=2).to(bf16)
        xb = x.to(bf16)[:, None, :]
        ok &= _record(results, "moe_decode_gate_up_i8", f"P={p} K={e_} FF={ff} G={g_}",
                      err, tol, timer(lambda: MD.moe_decode_gate_up_i8(*a7)),
                      timer(lambda: MD.moe_decode_gate_up_i8_ref(*a7), 3),
                      timer(lambda: torch.bmm(xb, wb)), bnd)
        del wb
        hq, hs = quantize_activations(ref)
        a8 = (hq, hs.t(), ids, down, dsw)
        got = MD.moe_decode_down_i8(*a8, top_k=topk)
        ref = MD.moe_decode_down_i8_ref(*a8, top_k=topk)
        sync(torch)
        err = float((got - ref).abs().max())
        # exact integer dots, corrections added in the same order: only
        # float32 reassociation may differ
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        bnd = bound_ms(p * ff + p * nsgf * 4 + p * 4 + nd * (ff * e_ + nsgf * e_ * 4)
                       + t * e_ * 4, 2.0 * p * ff * e_, INT8_OPS)
        wb = down[li].to(bf16)
        hb = hq.to(bf16)[:, None, :]
        ok &= _record(results, "moe_decode_down_i8", f"P={p} FF={ff} E={e_} G={g_}",
                      err, tol, timer(lambda: MD.moe_decode_down_i8(*a8, top_k=topk)),
                      timer(lambda: MD.moe_decode_down_i8_ref(*a8, top_k=topk), 3),
                      timer(lambda: torch.bmm(hb, wb)), bnd)
        del wb

    r = 40
    log("[3] kernel 9 (fused_moe_prefill_i8) vs plain; library = bf16 torch.bmm of "
        "the live buckets against their gate|up")
    for n_live in (g_, min(37, g_ // 2)):
        sizes = np.zeros(g_, np.int64)
        sizes[rng.permutation(g_)[:n_live]] = rng.integers(1, r + 1, n_live)
        sz = torch.from_numpy(sizes).to(dev)
        valid = torch.arange(r, device=dev)[None, :] < sz[:, None]
        xg = torch.randint(-127, 128, (g_, r, e_), generator=gen, device=dev, dtype=torch.int8)
        xg = torch.where(valid[..., None], xg, 0).to(torch.int8)
        xs = torch.rand((g_, r, nsg), generator=gen, device=dev) * 1e-2 + 1e-4
        xst = torch.where(valid[..., None], xs, 0.0).transpose(1, 2)
        ar = torch.arange(g_, device=dev)
        eids = torch.argsort(torch.where(sz > 0, ar, 2 * g_)).to(torch.int32)
        nl = torch.tensor(n_live, dtype=torch.int32, device=dev)
        a9 = (xg, xst, eids, nl, gate, gsw, up, usw, down, dsw)
        got = MQ.fused_moe_prefill_i8(*a9, capacity=r)
        ref = MQ.fused_moe_prefill_i8_ref(*a9, capacity=r)
        sync(torch)
        live = eids[:n_live].long()
        err = float((got[live] - ref[live]).abs().max())
        # a one-ulp float32 difference in the activation can move an h
        # across a bf16 boundary and one requantized h by one int8 step
        tol = 1e-2 * float(ref[live].abs().max())
        bnd = bound_ms(n_live * (r * e_ + nsg * r * 4) + g_ * 4 + 4
                       + n_live * (2 * e_ * ff + 2 * nsg * ff * 4 + ff * e_ + nsgf * e_ * 4)
                       + n_live * r * e_ * 4, n_live * r * (4.0 * e_ * ff + 2.0 * ff * e_),
                       INT8_OPS)
        wb = torch.cat([gate[live], up[live]], dim=2).to(bf16)
        xb = xg[live].to(bf16)
        ok &= _record(results, "fused_moe_prefill_i8",
                      f"G={g_} R={r} K={e_} FF={ff} E={e_} n_live={n_live}", err, tol,
                      timer(lambda: MQ.fused_moe_prefill_i8(*a9, capacity=r)),
                      timer(lambda: MQ.fused_moe_prefill_i8_ref(*a9, capacity=r), 3),
                      timer(lambda: torch.bmm(xb, wb)), bnd)
        del wb, xb

    m = PREFILL * topk                          # the rows of a 512-token chunk
    log("[3] kernel 10 (ragged_qmatmul_i8) vs plain; library = dense bf16 "
        "torch.matmul at the same (M, K, N)")
    skew = rng.multinomial(m, (1.0 / np.arange(1, g_ + 1)) / np.sum(1.0 / np.arange(1, g_ + 1)))
    size_sets = {"skewed": rng.permutation(skew), "zero": np.zeros(g_, np.int64),
                 "mid-tile": np.full(g_, m // g_)}    # 32-row groups: every other start is mid-tile
    for k, n, w, sw in ((e_, ff, gate, gsw), (ff, e_, down, dsw)):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand((m, k // 256), generator=gen, device=dev) * 1e-2 + 1e-4
        xb = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wd = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        for name, sizes in size_sets.items():
            gs = torch.from_numpy(sizes.astype(np.int32)).to(dev)
            total, ne = int(sizes.sum()), int((sizes > 0).sum())
            a10 = (xq, xs.t(), w, sw, gs)
            got = MQ.ragged_qmatmul_i8(*a10)
            ref = MQ.ragged_qmatmul_i8_ref(xq, xs, w, sw, gs)
            sync(torch)
            err = float((got[:total] - ref[:total]).abs().max()) if total else 0.0
            tol = 1e-5 * (float(ref[:total].abs().max()) if total else 0.0) + 1e-6
            nk = k // 256
            bnd = bound_ms(total * k + total * nk * 4 + ne * (k * n + nk * n * 4)
                           + total * n * 4 + g_ * 4, 2.0 * total * k * n, INT8_OPS)
            ok &= _record(results, "ragged_qmatmul_i8", f"M={m} K={k} N={n} {name}", err, tol,
                          timer(lambda: MQ.ragged_qmatmul_i8(*a10)),
                          timer(lambda: MQ.ragged_qmatmul_i8_ref(xq, xs, w, sw, gs), 3),
                          timer(lambda: torch.matmul(xb, wd)), bnd)
    return ok


def phase_planar_moe_kernels(torch, timer, results, dev="cuda") -> bool:
    """Kernels 12-14 (planar MoE decode and prefill), 11 (the single-kernel
    int8 decode) and 16 (the pair form of the planar GEMM) against their
    plain versions, at the shapes of Qwen1.5-MoE-A2.7B (60 experts, E 2048,
    FF 1408: gate/up supergroup with f32 scales, down group 32 with bf16
    scales) and of Qwen3-30B-A3B (128 experts, FF 768). Library yardsticks
    are bf16 torch.bmm / torch.matmul calls over the same rows and the
    gathered, dequantized experts: a comparable function, not the same."""
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    from ik_llama_cpp_tpu_torch.tools import perf_dequant as PD
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    ok = True

    def planar(g_, k, n, group, sdtype):
        """(codes (G, K, N) as the view of (G, N, K), scales (G, K/group, N))."""
        lim = 127 if group == 256 else 8
        codes = torch.randint(-lim, lim + 1, (g_, n, k), generator=gen, device=dev,
                              dtype=torch.int8).transpose(1, 2)
        sc = (torch.rand((g_, k // group, n), generator=gen, device=dev) + 0.5) \
            * (0.3 / lim / k ** 0.5)
        return codes, sc.to(sdtype)

    def routed(g_, t, topk):
        return torch.from_numpy(np.concatenate(
            [rng.permutation(g_)[:topk] for _ in range(t)]).astype(np.int32)).to(dev)

    def sum_tol(k, absdot):
        # both sum the same exact bf16 products in float32 in different
        # orders: 16 sqrt(K) float32 roundings of the largest sum of |x w|
        return 16 * k ** 0.5 * 2.0 ** -24 * absdot

    log("[3] kernel 12 (moe_decode_gate_up, planar) vs plain; library = bf16 torch.bmm "
        "over the gathered pairs' dequantized gate|up")
    q2, q3 = Q2MOE, MOE
    for c, t, group, sdt in ((q2, 1, 256, torch.float32), (q3, 1, 32, bf16),
                             (q2, 8, 256, torch.float32)):
        g_, k, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
        p = t * topk
        gate, gs = planar(g_, k, ff, group, sdt)
        up, us = planar(g_, k, ff, group, sdt)
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        x = torch.randn((p, k), generator=gen, device=dev).to(bf16)
        a12 = (x, ids, gate, gs, up, us)
        got = MD.moe_decode_gate_up(*a12, group=group)
        ref = MD.moe_decode_gate_up_ref(*a12, group=group)
        sync(torch)
        err = float((got.float() - ref.float()).abs().max())
        tol = 2.0 ** -7 * float(ref.float().abs().max())   # h is bf16: two ulps of the largest
        sb = gs.element_size()
        bnd = bound_ms(p * k * 2 + p * 4 + nd * 2 * (k * ff + (k // group) * ff * sb)
                       + p * ff * 2, 4.0 * p * k * ff, BF16_FLOPS)
        li = ids.long()
        wb = torch.cat([MD.dequant_experts(gate[li], gs[li], group),
                        MD.dequant_experts(up[li], us[li], group)], dim=2)
        xb = x[:, None, :]
        ok &= _record(results, "moe_decode_gate_up",
                      f"P={p} K={k} FF={ff} G={g_} group={group} "
                      f"{'f32' if sdt == torch.float32 else 'bf16'} scales", err, tol,
                      timer(lambda: MD.moe_decode_gate_up(*a12, group=group)),
                      timer(lambda: MD.moe_decode_gate_up_ref(*a12, group=group), 3),
                      timer(lambda: torch.bmm(xb, wb)), bnd)
        del wb, gate, up

    log("[3] kernel 13 (moe_decode_down, planar) vs plain; library = bf16 torch.bmm over "
        "the gathered pairs' dequantized down")
    for c, t in ((q2, 1), (q3, 1), (q2, 8)):
        g_, e_, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
        p = t * topk
        down, ds = planar(g_, ff, e_, 32, bf16)
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        hw = torch.randn((p, ff), generator=gen, device=dev).to(bf16)
        got = MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32)
        ref = MD.moe_decode_down_ref(hw, ids, down, ds, top_k=topk, group=32)
        li = ids.long()
        wb = MD.dequant_experts(down[li], ds[li], 32)
        absdot = float(torch.bmm(hw.float().abs()[:, None], wb.float().abs())
                       .reshape(t, topk, e_).sum(1).max())
        sync(torch)
        err = float((got - ref).abs().max())
        bnd = bound_ms(p * ff * 2 + p * 4 + nd * (ff * e_ + (ff // 32) * e_ * 2) + t * e_ * 4,
                       2.0 * p * ff * e_, BF16_FLOPS)
        hb = hw[:, None, :]
        ok &= _record(results, "moe_decode_down",
                      f"P={p} FF={ff} E={e_} G={g_} group=32 bf16 scales", err,
                      sum_tol(ff * topk, absdot),
                      timer(lambda: MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32)),
                      timer(lambda: MD.moe_decode_down_ref(hw, ids, down, ds, top_k=topk,
                                                           group=32), 3),
                      timer(lambda: torch.bmm(hb, wb)), bnd)
        del wb, down

    log("[3] kernel 14 (ragged_qmatmul, planar) vs plain; library = dense bf16 "
        "torch.matmul at the same (M, K, N)")
    for c, k, n in ((q2, q2["FF"], q2["E"]), (q3, q3["E"], q3["FF"])):
        g_ = c["G"]
        m = PREFILL * c["TOPK"]
        codes, sc = planar(g_, k, n, 32, bf16)
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wd = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        harm = 1.0 / np.arange(1, g_ + 1)
        size_sets = {"random": rng.multinomial(m, np.full(g_, 1.0 / g_)),
                     "skewed": rng.permutation(rng.multinomial(m, harm / harm.sum())),
                     "zero": np.zeros(g_, np.int64)}
        for name, sizes in size_sets.items():
            if c is q3 and name != "skewed":
                continue
            gsz = torch.from_numpy(sizes.astype(np.int32)).to(dev)
            total, ne = int(sizes.sum()), int((sizes > 0).sum())
            got = MQ.ragged_qmatmul(x, codes, sc, gsz, group=32)
            ref = MQ.ragged_qmatmul_ref(x, codes, sc, gsz, group=32)
            sync(torch)
            err = float((got[:total] - ref[:total]).abs().max()) if total else 0.0
            # the largest sum of |x w| over the live rows, from their own experts
            absdot = float(MQ.ragged_qmatmul_ref(x.abs(), codes.abs(), sc, gsz, group=32)
                           [:total].max()) if total else 0.0
            bnd = bound_ms(total * k * 2 + ne * (k * n + (k // 32) * n * 2) + total * n * 4
                           + g_ * 4, 2.0 * total * k * n, BF16_FLOPS)
            ok &= _record(results, "ragged_qmatmul",
                          f"M={m} K={k} N={n} G={g_} group=32 {name}", err,
                          sum_tol(k, absdot) + 1e-12,
                          timer(lambda: MQ.ragged_qmatmul(x, codes, sc, gsz, group=32)),
                          timer(lambda: MQ.ragged_qmatmul_ref(x, codes, sc, gsz, group=32), 3),
                          timer(lambda: torch.matmul(x, wd)), bnd)
        del codes, wd

    log("[3] kernel 11 (moe_decode_fused_i8, one launch) vs plain, beside kernels 7 + 8 "
        "on the same inputs; library = bf16 torch.bmm over the gathered gate|up, then down")
    g_, e_, ff, topk = q3["G"], q3["E"], q3["FF"], q3["TOPK"]
    gate, gsw = planar(g_, e_, ff, 256, torch.float32)
    up, usw = planar(g_, e_, ff, 256, torch.float32)
    down, dsw = planar(g_, ff, e_, 256, torch.float32)
    nsg, nsgf = e_ // 256, ff // 256
    for t in (1, 8):
        p = t * topk
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        x = torch.randn((p, e_), generator=gen, device=dev)
        wts = torch.rand(p, generator=gen, device=dev) * 0.5 + 0.05
        xq, xs = quantize_activations(x)
        a11 = (xq, xs.t(), ids, wts, gate, gsw, up, usw, down, dsw)
        got = MD.moe_decode_fused_i8(*a11, top_k=topk)
        ref = MD.moe_decode_fused_i8_ref(*a11, top_k=topk)
        sync(torch)
        err = float((got - ref).abs().max())
        # the same exact integer dots, corrections, bf16 roundings and
        # requantization in the same order as the plain version: only a
        # float32 reassociation may differ
        tol = 1e-5 * float(ref.abs().max()) + 1e-6

        def two_kernels():
            h = MD.moe_decode_gate_up_i8(xq, xs.t(), ids, gate, gsw, up, usw)
            h = (h.float() * wts[:, None]).to(bf16)
            hq, hs = quantize_activations(h)
            return MD.moe_decode_down_i8(hq, hs.t(), ids, down, dsw, top_k=topk)

        ms78 = timer(two_kernels)
        bnd = bound_ms(p * e_ + p * nsg * 4 + 2 * p * 4
                       + nd * (2 * e_ * ff + 2 * nsg * ff * 4 + ff * e_ + nsgf * e_ * 4)
                       + t * e_ * 4, p * (4.0 * e_ * ff + 2.0 * ff * e_), INT8_OPS)
        li = ids.long()
        wgu = torch.cat([gate[li], up[li]], dim=2).to(bf16)
        wdn = down[li].to(bf16)
        xb = x.to(bf16)[:, None, :]
        hb = torch.randn((p, 1, ff), generator=gen, device=dev).to(bf16)
        ok &= _record(results, "moe_decode_fused_i8",
                      f"P={p} K={e_} FF={ff} E={e_} G={g_}", err, tol,
                      timer(lambda: MD.moe_decode_fused_i8(*a11, top_k=topk)),
                      timer(lambda: MD.moe_decode_fused_i8_ref(*a11, top_k=topk), 3),
                      timer(lambda: (torch.bmm(xb, wgu), torch.bmm(hb, wdn))), bnd,
                      note=f" | kernels 7 + 8 with the glue between them {ms78:.4f} ms; "
                           f"bit-identical to plain: {bool(torch.equal(got, ref))}")
        del wgu, wdn
    del gate, up, down

    log("[3] kernel 16 (qmatmul_pair, two codes a 16-bit lane) vs plain, beside kernel D "
        "on the same codes; library = dense bf16 torch.matmul at the same (M, K, N)")
    m, k, n = 16, E, FF
    codes_np = rng.integers(-8, 8, (k, n), dtype=np.int8)
    codes = torch.from_numpy(codes_np).to(dev)
    packed = torch.from_numpy(PD.pack_pairs(codes_np)).to(dev)
    scale = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.02).to(bf16)
    x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
    wb = torch.randn((k, n), generator=gen, device=dev).to(bf16)
    got = PD.qmatmul_pair(x, packed, scale)
    ref = PD.qmatmul_pair_ref(x, packed, scale)
    same_as_d = bool(torch.equal(got, QM.qmatmul(x, codes, scale)))
    absdot = float((x.float().abs() @ QM._dequant_bf16(codes, scale, None, 32).float().abs()).max())
    sync(torch)
    err = float((got - ref).abs().max())
    ms_d = timer(lambda: QM.qmatmul(x, codes, scale))
    bnd = bound_ms(m * k * 2 + k * n + (k // 32) * n * 2 + m * n * 4, 2.0 * m * n * k, BF16_FLOPS)
    ok &= _record(results, "qmatmul_pair", f"M={m} K={k} N={n}", err, sum_tol(k, absdot),
                  timer(lambda: PD.qmatmul_pair(x, packed, scale)),
                  timer(lambda: PD.qmatmul_pair_ref(x, packed, scale), 3),
                  timer(lambda: torch.matmul(x, wb)), bnd,
                  note=f" | kernel D on the unpacked codes {ms_d:.4f} ms; "
                       f"bit-identical to kernel D: {same_as_d}")
    return ok


def phase_quantizers(torch) -> bool:
    """The eager quantizers around the kernels (activations per supergroup,
    the requantization of h, the four KV encoders) give the CPU's bits on
    the card: scales are true float32 divisions there too."""
    from ik_llama_cpp_tpu_torch.ops.kv_quant import KV_ENCODERS
    from ik_llama_cpp_tpu_torch.ops.moe_decode import requant_by_inverse
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((256, 2048)) * 3)
                         .astype(np.float32))
    fns = {"quantize_activations": (quantize_activations, x),
           "requant_by_inverse": (requant_by_inverse, x)}
    fns.update({f"kv encoder {k}": (enc, x.reshape(4, 64, 16, 128))
                for k, enc in KV_ENCODERS.items()})
    bad = []
    for name, (fn, arg) in fns.items():
        (qc, sc), (qg, sg) = fn(arg), fn(arg.cuda())
        if not (torch.equal(sc, sg.cpu()) and torch.equal(qc, qg.cpu())):
            bad.append(name)
    log(f"[3] quantizers on the card against the CPU, codes and scales bit for bit "
        f"({', '.join(fns)}): {'ok' if not bad else 'FAIL ' + str(bad)}")
    return not bad


def phase_kvq_kernels(torch, timer, results) -> bool:
    """Kernels 5 (decode attention over a quantized slab, four codecs), 6
    (prefill attention over an int8 cache) and 15 (4-bit packed GEMM)
    against their plain versions at the dense path's shapes."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import kv_quant as KQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    scale_ = 1.0 / float(np.sqrt(D))
    ok = True

    def attn_case(kernel, fn, codec, b, t, s, qpos, kvlen, **kw):
        q = torch.randn((b, t, H, D), generator=gen, device="cuda").to(bf16)
        # the layer slab is a view of a stacked cache, as on the main path
        enc = KQ.KV_ENCODERS[codec]
        kq, ks = enc(torch.randn((2, b, s, HKV, D), generator=gen, device="cuda"))
        vq, vs = enc(torch.randn((2, b, s, HKV, D), generator=gen, device="cuda"))
        kq, ks, vq, vs = kq[1], ks[1], vq[1], vs[1]
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        args = (q, kq, ks, vq, vs, qp, kl)
        got = fn(*args, scale=scale_, **kw)
        ref = FA.attention_quant_ref(*args, scale=scale_, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        # p is rounded to bf16 before the PV product and the output is bf16:
        # two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        # library: the slab dequantized to bf16, then SDPA with an explicit
        # mask (mask and GQA repeat not timed); and SDPA alone
        pos = torch.arange(s, device="cuda")
        qpos_t = qp[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos_t[:, :, None]) & (pos[None, None, :] < kl[:, None, None])
        swa = kw.get("swa_window", 0)
        if swa:
            mask &= pos[None, None, :] > qpos_t[:, :, None] - swa
        m4 = mask[:, None]
        qt = q.transpose(1, 2)
        dec = KQ.KV_DECODERS[codec]

        def lib_full():
            kr = dec(kq, ks).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
            vr = dec(vq, vs).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4, scale=scale_)

        kr = dec(kq, ks).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        vr = dec(vq, vs).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        lib = timer(lib_full)
        sdpa = timer(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4,
                                                            scale=scale_))
        del kr, vr
        live = int(mask.sum())               # (query, key) pairs this run needs
        lo = [max(0, qpos[i] - swa + 1) if swa else 0 for i in range(b)]
        keys = sum(min(kvlen[i], qpos[i] + t) - lo[i] for i in range(b))
        row_bytes = kq.shape[-1] + vq.shape[-1] + 8          # codes + two f32 scales
        bnd = bound_ms(2 * (b * t * H * D * 2) + keys * HKV * row_bytes,
                       4.0 * H * D * live, BF16_FLOPS)
        extra = "".join(f" {k}" for k in kw)
        case = f"{codec} B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen}{extra}"
        return _record(results, kernel, case, err, tol,
                       timer(lambda: fn(*args, scale=scale_, **kw)),
                       timer(lambda: FA.attention_quant_ref(*args, scale=scale_, **kw), 3),
                       lib, bnd, note=f" | SDPA alone {sdpa:.4f} ms")

    log("[3] kernel 5 (flash_attention_decode_q8, codecs q8/q4/q6/nl4) vs plain; "
        "library = the slab dequantized to bf16 + SDPA (both timed together)")
    for codec in ("q8", "q4", "q6", "nl4"):
        for t in (1, 8):
            for s, kvl in ((1024, 513), (4096, 4000)):
                ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8,
                                codec, 1, t, s, [kvl - t], [kvl])
    sinks = torch.randn(H, generator=gen, device="cuda")
    ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8, "q6",
                    1, 1, 1024, [512], [513], sinks=sinks, swa_window=256)
    log("[3] kernel 6 (flash_attention_q8, prefill over int8 KV) vs plain; library as for 5")
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 1024, [0], [512])
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 1024, [256], [768])

    log("[3] kernel 15 (qmatmul4, 4-bit packed, group 32) vs plain; library = dense "
        "bf16 torch.matmul at the same (M, K, N), a yardstick, not the same function")
    shapes = [(E, (H + 2 * HKV) * D), (E, E), (E, 2 * FF), (FF, E), (E, V)]
    iq4nl = tuple(float(v) for v in KQ.IQ4NL_VALUES)       # a 16-level codebook
    for k, n in shapes:
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                               dtype=torch.uint8)
        scale = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(bf16)
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=bf16)
        for lut in (None, iq4nl):
            sc = scale if lut is None else (scale * 0.1).to(bf16)
            for m in (1, 8, 512):
                x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
                got = QM.qmatmul4(x, packed, sc, lut16=lut)
                ref = QM.qmatmul4_ref(x, packed, sc, lut16=lut)
                absdot = float((x.float().abs() @ QM._dequant4_bf16(
                    packed, sc, None, 32, lut).float().abs()).max())
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                # both sum the same exact bf16 products in float32 in different
                # orders: 16 sqrt(K) float32 roundings of the largest sum of |x w|
                tol = 16 * k ** 0.5 * 2.0 ** -24 * absdot
                bnd = bound_ms(m * k * 2 + k * n // 2 + (k // 32) * n * 2 + m * n * 4,
                               2.0 * m * n * k, BF16_FLOPS)
                ok &= _record(results, "qmatmul4", f"M={m} K={k} N={n}"
                              + (" codebook" if lut is not None else ""), err, tol,
                              timer(lambda: QM.qmatmul4(x, packed, sc, lut16=lut)),
                              timer(lambda: QM.qmatmul4_ref(x, packed, sc, lut16=lut), 3),
                              timer(lambda: torch.matmul(x, wb)), bnd)
        del packed, wb
    return ok


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def build_gguf(path: Path) -> Path:
    """The full-width llama layer as GGUF (one block; Q4_0 planar weights, a
    Q8_0 tied head), random weights from seed 0; cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    from ik_llama_cpp_tpu_torch.quant.quantize import quantize
    meta = json.dumps(dict(v=GGUF_VERSION, E=E, H=H, HKV=HKV, FF=FF, V=V))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    w = GGUFWriter(str(path), arch="llama")
    for key, val in (("block_count", 1), ("context_length", 8192),
                     ("embedding_length", E), ("feed_forward_length", FF),
                     ("attention.head_count", H), ("attention.head_count_kv", HKV),
                     ("attention.layer_norm_rms_epsilon", 1e-5),
                     ("rope.freq_base", 500000.0), ("rope.dimension_count", D),
                     ("vocab_size", V)):
        w.add(f"llama.{key}", val)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", ["<unk>", "<s>", "</s>"]
          + [f"<t{i}>" for i in range(V - 3)])
    w.add("tokenizer.ggml.scores", np.zeros(V, np.float32))
    w.add("tokenizer.ggml.token_type", np.asarray([2, 3, 3] + [1] * (V - 3), np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0):
        arr = rng.standard_normal((rows, cols), dtype=np.float32) / np.sqrt(cols)
        w.add_tensor(name, quantize(arr, ttype), shape=(cols, rows), ggml_type=ttype)

    q("token_embd.weight", V, E, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(E, np.float32))
    p = "blk.0."
    w.add_tensor(p + "attn_norm.weight", np.ones(E, np.float32))
    w.add_tensor(p + "ffn_norm.weight", np.ones(E, np.float32))
    q(p + "attn_q.weight", E, E)
    q(p + "attn_k.weight", HKV * D, E)
    q(p + "attn_v.weight", HKV * D, E)
    q(p + "attn_output.weight", E, E)
    q(p + "ffn_gate.weight", FF, E)
    q(p + "ffn_up.weight", FF, E)
    q(p + "ffn_down.weight", E, FF)
    w.write()
    mpath.write_text(meta)
    return path


def _rand_blocks(rng, rows: int, cols: int, ttype) -> np.ndarray:
    """Random Q4_0 / Q8_0 blocks of a (rows, cols) weight, written directly
    (uniform codes, f16 scales sized for weights of about 1/sqrt(cols))
    so that a 1 GB file takes seconds; loading still runs the planar
    decode and the supergroup recode."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    width, code_std = (16, 4.6) if ttype == GGMLType.Q4_0 else (32, 73.9)
    nb = rows * cols // 32
    d = (rng.uniform(0.5, 1.5, nb) / (code_std * np.sqrt(cols))).astype(np.float16)
    out = np.empty((nb, 2 + width), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:] = rng.integers(0, 256, (nb, width), dtype=np.uint8)
    return out


def build_moe_gguf(path: Path, c=MOE) -> Path:
    """One MoE layer of architecture c["ARCH"] at the width ``c`` (Q4_0
    attention and experts, Q8_0 embedding and untied head, an f32 router,
    unit norms; qwen3moe: QK-norms; qwen2moe: q/k/v biases and a Q4_0
    shared expert of width c["FFS"] with an f32 sigmoid gate), random
    blocks from seed 0; cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=MOE_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    e, h, hkv, d, g, ff, v = (c[k] for k in ("E", "H", "HKV", "D", "G", "FF", "V"))
    arch = c["ARCH"]
    w = GGUFWriter(str(path), arch=arch)
    if "FFS" in c:
        w.add(f"{arch}.expert_shared_feed_forward_length", c["FFS"])
    for key, val in (("block_count", 1), ("context_length", 40960),
                     ("embedding_length", e), ("feed_forward_length", 6144),
                     ("expert_feed_forward_length", ff), ("expert_count", g),
                     ("expert_used_count", c["TOPK"]), ("attention.head_count", h),
                     ("attention.head_count_kv", hkv), ("attention.key_length", d),
                     ("attention.value_length", d),
                     ("attention.layer_norm_rms_epsilon", 1e-6),
                     ("rope.freq_base", 1000000.0), ("rope.dimension_count", d),
                     ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    q("output.weight", v, e, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(e, np.float32))
    p = "blk.0."
    norms = [("attn_norm", e), ("ffn_norm", e)]
    if arch == "qwen3moe":
        norms += [("attn_q_norm", d), ("attn_k_norm", d)]
    for name, width in norms:
        w.add_tensor(p + name + ".weight", np.ones(width, np.float32))
    q(p + "attn_q.weight", h * d, e)
    q(p + "attn_k.weight", hkv * d, e)
    q(p + "attn_v.weight", hkv * d, e)
    q(p + "attn_output.weight", e, h * d)
    w.add_tensor(p + "ffn_gate_inp.weight",
                 rng.standard_normal((g, e), dtype=np.float32) / np.float32(np.sqrt(e)))
    q(p + "ffn_gate_exps.weight", ff, e, n=g)
    q(p + "ffn_up_exps.weight", ff, e, n=g)
    q(p + "ffn_down_exps.weight", e, ff, n=g)
    if arch == "qwen2moe":
        for name, width in (("attn_q", h * d), ("attn_k", hkv * d), ("attn_v", hkv * d)):
            w.add_tensor(p + name + ".bias",
                         (rng.standard_normal(width) * 0.1).astype(np.float32))
        q(p + "ffn_gate_shexp.weight", c["FFS"], e)
        q(p + "ffn_up_shexp.weight", c["FFS"], e)
        q(p + "ffn_down_shexp.weight", e, c["FFS"])
        w.add_tensor(p + "ffn_gate_inp_shexp.weight",
                     rng.standard_normal((1, e), dtype=np.float32) / np.float32(np.sqrt(e)))
    w.write()
    mpath.write_text(meta)
    return path


def clone_layers(rt, n_layer: int):
    """Block 0 cloned into n_layer distinct blocks (no aliasing)."""
    blk0 = rt.params["blocks"][0]
    rt.params["blocks"] = [copy.deepcopy(blk0) for _ in range(n_layer)]
    rt.cfg = replace(rt.cfg, n_layer=n_layer)
    return rt


def counters():
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.tools import perf_dequant as PD
    return {"qmatmul_i8": QM.qmatmul_i8, "flash_attention": FA.flash_attention,
            "flash_attention_decode": FA.flash_attention_decode,
            "qmatmul": QM.qmatmul,
            "flash_attention_decode_q8": FA.flash_attention_decode_q8,
            "flash_attention_q8": FA.flash_attention_q8, "qmatmul4": QM.qmatmul4,
            "moe_decode_gate_up_i8": MD.moe_decode_gate_up_i8,
            "moe_decode_down_i8": MD.moe_decode_down_i8,
            "fused_moe_prefill_i8": MQ.fused_moe_prefill_i8,
            "ragged_qmatmul_i8": MQ.ragged_qmatmul_i8,
            "moe_decode_fused_i8": MD.moe_decode_fused_i8,
            "moe_decode_gate_up": MD.moe_decode_gate_up,
            "moe_decode_down": MD.moe_decode_down,
            "ragged_qmatmul": MQ.ragged_qmatmul, "qmatmul_pair": PD.qmatmul_pair}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {k: f.launches for k, f in counters().items()}


def phase_e2e(torch, gguf: Path, launches: dict) -> bool:
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    log(f"[4] loaded L{NL} E{E} H{H} KV{HKV} FF{FF} V{V} in {load_s:.1f} s "
        f"(numpy planar decode + supergroup recode of one layer, then "
        f"{NL} device clones); linears {kinds}")
    rng = np.random.default_rng(1)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, V, PREFILL)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.update({k: counts[k] for k in ("qmatmul_i8", "flash_attention",
                                            "flash_attention_decode")})
    per = 4 * NL + 1
    want = dict.fromkeys(counts, 0)
    want.update({"qmatmul_i8": per * (1 + DECODE), "flash_attention": NL,
                 "flash_attention_decode": NL * DECODE})
    log(f"[4] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = "
        f"{PREFILL / pre_s:.1f} tok/s; decode {DECODE} tokens at context "
        f"{PREFILL}: {dec_s * 1e3:.1f} ms = {DECODE / dec_s:.2f} tok/s; "
        f"peak memory {peak:.2f} GiB")
    log(f"[4] launches {counts}; expected {want} (per decode step A = 4*{NL}+1 "
        f"= {per}, C = {NL}; the prefill chunk A = {per}, B = {NL})")
    ok = counts == want
    tail = rt.eval_tokens([int(toks[0, -1])], kv, n_past + DECODE)[0]
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(tail).all())
    in_range = bool(((toks >= 0) & (toks < V)).all())
    log(f"[4] logits finite: {finite}; tokens in vocab: {in_range}; "
        f"first tokens {toks[0, :8].tolist()}")
    profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:])
    del rt, kv
    torch.cuda.empty_cache()
    return ok and finite and in_range


def timed_run(torch, rt, ids, n_decode: int = DECODE):
    """Prefill ``ids`` then decode n_decode tokens greedily, each half timed
    on the host clock around a synchronize."""
    kv = rt.new_cache(1, len(ids) + DECODE + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = rt._decode_loop(first, kv, n_past, n_decode)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, toks, kv, n_past, t1 - t0, t2 - t1


def profile_decode(torch, rt, kv, n_past: int, tok, steps: int = 8, tag: str = "4",
                   top: int = 12) -> dict:
    """Device time by kernel over a few decode steps (torch.profiler), and
    the share of the wall time the card was busy."""
    rt._decode_loop(tok, kv, n_past, 2)                  # warm
    return profile_window(torch, lambda: rt._decode_loop(tok, kv, n_past, steps), steps,
                          f"{steps} decode steps", "step", tag, top)


def profile_window(torch, fn, steps: int, what: str, unit: str, tag: str,
                   top: int = 12) -> dict:
    """Run fn once under torch.profiler: device time and launches by
    kernel per ``unit``, and the share of the wall time the card was busy.
    Returns {kernel name: ms per unit}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    calls = sum(r[2] for r in rows)
    log(f"[{tag}] profile of {what} (under the profiler): wall {wall * 1e3:.1f} ms, "
        f"kernels {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% busy, "
        f"{100 * (1 - busy / wall):.1f}% idle), {len(rows)} kernel kinds, "
        f"{calls // steps} launches/{unit}")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {us / 1e3 / steps:9.3f} ms/{unit}  {n // steps:5d} calls/{unit}  {key[:90]}")
    return {key: us / 1e3 / steps for key, us, _ in rows}


def kernel_ms(prof: dict, *names: str) -> float:
    """ms per unit of the profiled kernels whose name holds one of ``names``."""
    return sum(ms for key, ms in prof.items() if any(n in key for n in names))


@contextmanager
def plain_path():
    """Route the model through the plain versions on the same tensors."""
    from ik_llama_cpp_tpu_torch.models import llama, weights
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import moe
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    saved = (weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
             llama.flash_attention_decode, MD.moe_decode_gate_up_i8,
             MD.moe_decode_down_i8, moe.fused_moe_prefill_i8, moe.ragged_qmatmul_i8,
             weights.qmatmul4, llama.flash_attention_decode_q8, llama.flash_attention_q8,
             MD.moe_decode_gate_up, MD.moe_decode_down, MD.moe_decode_fused_i8,
             moe.ragged_qmatmul)
    weights.qmatmul_i8, weights.qmatmul = QM.qmatmul_i8_ref, QM.qmatmul_ref
    weights.qmatmul4 = QM.qmatmul4_ref
    llama.flash_attention = llama.flash_attention_decode = FA.attention_ref
    llama.flash_attention_decode_q8 = llama.flash_attention_q8 = FA.attention_quant_ref
    MD.moe_decode_gate_up_i8 = MD.moe_decode_gate_up_i8_ref
    MD.moe_decode_down_i8 = MD.moe_decode_down_i8_ref
    moe.fused_moe_prefill_i8 = MQ.fused_moe_prefill_i8_ref
    MD.moe_decode_gate_up, MD.moe_decode_down = MD.moe_decode_gate_up_ref, MD.moe_decode_down_ref
    MD.moe_decode_fused_i8, moe.ragged_qmatmul = MD.moe_decode_fused_i8_ref, MQ.ragged_qmatmul_ref
    moe.ragged_qmatmul_i8 = (lambda xq, xst, codes, sw, gs:
                             MQ.ragged_qmatmul_i8_ref(xq, xst.t(), codes, sw, gs))
    try:
        yield
    finally:
        (weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
         llama.flash_attention_decode, MD.moe_decode_gate_up_i8,
         MD.moe_decode_down_i8, moe.fused_moe_prefill_i8, moe.ragged_qmatmul_i8,
         weights.qmatmul4, llama.flash_attention_decode_q8,
         llama.flash_attention_q8, MD.moe_decode_gate_up, MD.moe_decode_down,
         MD.moe_decode_fused_i8, moe.ragged_qmatmul) = saved


def greedy_from(torch, rt, kv, n, last_logits, steps):
    """steps greedy tokens from a filled cache; returns (tokens, the logits
    each token was picked from plus the last step's)."""
    from ik_llama_cpp_tpu_torch.models import llama
    outs, toks = [last_logits], []
    for s in range(steps):
        tok = int(torch.argmax(outs[-1]))
        toks.append(tok)
        lg = llama.forward(rt.params, rt.cfg,
                           torch.tensor([[tok]], device="cuda"), kv, n + s,
                           logits_last_only=True)
        outs.append(lg[0, -1])
    return toks, torch.stack(outs)


def greedy(torch, rt, ids, steps, with_cache: bool = False):
    kv = rt.new_cache(1, len(ids) + steps + 8)
    logits, kv, n = rt.eval_tokens(ids, kv, 0)
    toks, outs = greedy_from(torch, rt, kv, n, logits[-1], steps)
    return (toks, outs, kv, n + steps) if with_cache else (toks, outs)


def forced_logits(torch, rt, kv, n, last_logits, toks):
    """The logits of feeding ``toks`` one by one from a filled cache: the
    same history for both paths, whatever each would have picked."""
    outs = [last_logits]
    for s, tok in enumerate(toks):
        outs.append(llama_step(torch, rt, torch.tensor([[tok]], device="cuda"), kv, n + s))
    return torch.stack(outs)


def forced_parity(torch, rt, ids, steps: int):
    """Kernel path: prefill ``ids`` and decode ``steps`` greedy tokens. Plain
    path: the same prompt and the same tokens fed back (teacher forcing), so
    every step compares logits over one history. Returns (tokens, kernel
    logits, plain logits, kernel cache, plain cache, n_past)."""
    tk, lk, kvk, n = greedy(torch, rt, ids, steps, with_cache=True)
    with plain_path():
        kvp = rt.new_cache(1, len(ids) + steps + 8)
        logits, kvp, n0 = rt.eval_tokens(ids, kvp, 0)
        lp = forced_logits(torch, rt, kvp, n0, logits[-1], tk)
    return tk, lk, lp, kvk, kvp, n


def parity_verdict(lk, lp):
    """(ok, text): every step's logits within 5% of the largest logit (the
    rule of phase 5: the attention kernels round their probabilities to
    bf16, and a one-ulp bf16 difference can move an activation across an
    int8 rounding step), and where the two paths' greedy picks differ, the
    plain path's top-2 gap there, which the logit error must explain."""
    err = (lk - lp).abs().amax(dim=1)
    scale = float(lp.abs().max())
    top2 = lp.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    same = lk.argmax(dim=1) == lp.argmax(dim=1)
    flips = [(i, round(float(gap[i]), 4), round(float(err[i]), 4))
             for i in range(len(same)) if not bool(same[i])]
    ok = float(err.max()) <= 5e-2 * scale and all(g <= 2 * e for _, g, e in flips)
    text = (f"logits max_abs_err {float(err.max()):.3e} over {len(same)} steps of one "
            f"history (max |logit| {scale:.3f}, tol 5% of it); greedy picks identical at "
            f"{int(same.sum())} of {len(same)} steps"
            + (f", the others at near-ties (step, plain top-2 gap, logit error there): {flips}"
               if flips else ""))
    return ok, text


def phase_parity(torch, gguf: Path) -> bool:
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), 2)
    ids = [int(x) for x in np.random.default_rng(2).integers(3, V, 128)]
    tk, lk = greedy(torch, rt, ids, 16)
    with plain_path():
        tp, lp = greedy(torch, rt, ids, 16)
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    tol = 5e-2 * scale
    same = tk == tp
    log(f"[5] depth-2 parity, kernel path vs plain path: tokens identical over "
        f"16 steps: {same}; logits max_abs_err {err:.3e} (max |logit| "
        f"{scale:.3f}, tol {tol:.3e} = 5% of it: the attention kernel rounds "
        f"its probabilities to bf16, a one-ulp bf16 difference can move an "
        f"activation across an int8 rounding step, and one int8 step is 1/127 "
        f"of its supergroup's absmax)")
    if not same:
        log(f"    kernel {tk}\n    plain  {tp}")
    del rt
    torch.cuda.empty_cache()
    return same and err <= tol


def phase_planar(torch, gguf: Path, launches: dict) -> bool:
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    weights.set_i8_mxu(False)
    try:
        rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), 2)
    finally:
        weights.set_i8_mxu(None)
    kinds = _linear_kinds(rt)
    ids = [int(x) for x in np.random.default_rng(3).integers(3, V, 64)]
    reset_counts()
    kv = rt.new_cache(1, 64 + 16)
    logits, kv, n = rt.eval_tokens(ids, kv, 0)
    toks = rt._decode_loop(torch.argmax(logits[-1]).reshape(1, 1), kv, n, 8)
    torch.cuda.synchronize()
    counts = read_counts()
    launches["qmatmul"] = counts["qmatmul"]
    finite = bool(torch.isfinite(logits).all())
    log(f"[6] planar path (int8 path off, depth 2, linears {kinds}): prefill 64 "
        f"+ 8 decode steps; launches {counts}; logits finite {finite}; tokens "
        f"{toks[0].tolist()}")
    del rt, kv
    torch.cuda.empty_cache()
    return counts["qmatmul"] == 9 * 9 and finite


def moe_run(torch, rt, c, seed: int, tag: str, step: dict, chunk: dict, load_s: float):
    """Warm up, then prefill 512 and decode 64 with the launch counts set to
    0 just before and read just after. Returns (ok, counts, ids, toks, kv,
    n_past)."""
    v = c["V"]
    rng = np.random.default_rng(seed)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, v, PREFILL)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, v, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: chunk.get(k, 0) + DECODE * step.get(k, 0) for k in counts}
    log(f"[{tag}] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = {PREFILL / pre_s:.1f} "
        f"tok/s; decode {DECODE} tokens at context {PREFILL}: {dec_s * 1e3:.1f} ms = "
        f"{DECODE / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB; load {load_s:.1f} s")
    log(f"[{tag}] launches { {k: n for k, n in counts.items() if n} }; as expected: "
        f"{counts == want} (per decode step {step}; per {PREFILL}-token chunk {chunk}; "
        f"every other kernel 0)")
    if counts != want:
        log(f"    expected { {k: n for k, n in want.items() if n} }")
    tail = rt.eval_tokens([int(toks[0, -1])], kv, n_past + DECODE)[0]
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(tail).all())
    in_range = bool(((toks >= 0) & (toks < v)).all())
    log(f"[{tag}] logits finite: {finite}; tokens in vocab: {in_range}; first tokens "
        f"{toks[0, :8].tolist()}")
    return counts == want and finite and in_range, counts, ids, toks, kv, n_past


def depth2(torch, rt):
    rt.params["blocks"] = rt.params["blocks"][:2]
    rt.cfg = replace(rt.cfg, n_layer=2)
    torch.cuda.empty_cache()


@contextmanager
def fused_decode_env():
    """IK_MOE_FUSED_TG=1 (read at call time by moe_ffn), restored after."""
    old = os.environ.get("IK_MOE_FUSED_TG")
    os.environ["IK_MOE_FUSED_TG"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["IK_MOE_FUSED_TG"]
        else:
            os.environ["IK_MOE_FUSED_TG"] = old


def phase_moe(torch, gguf: Path, launches: dict, phases: set, c=MOE) -> bool:
    """On one loaded Qwen3-30B-A3B model: phase 7 (full width, launch
    counts, profiles), phase 14 (the single-kernel decode at full width),
    then at depth 2 phase 8 (greedy parity, kernel path against plain path)
    and phase 13c (parity of the single-kernel decode over one history)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    nl, v = c["L"], c["V"]
    t_phase = t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), nl)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ex = rt.params["blocks"][0]["experts"]
    log(f"[7] loaded qwen3moe L{nl} E{c['E']} H{c['H']} KV{c['HKV']} D{c['D']} "
        f"experts {c['G']} top-{c['TOPK']} FF{c['FF']} V{v} in {load_s:.1f} s (numpy "
        f"planar decode + supergroup recode of one layer, {nl} device clones); "
        f"expert codes {tuple(ex.gate.shape)} x3, groups {ex.gate_group}; device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = True
    chunk = {"qmatmul_i8": 2 * nl + 1, "flash_attention": nl,
             "fused_moe_prefill_i8": nl, "ragged_qmatmul_i8": 3 * nl}
    two_kernel_ms = step_ms = None
    if 7 in phases:
        step = {"qmatmul_i8": 2 * nl + 1, "flash_attention_decode": nl,
                "moe_decode_gate_up_i8": nl, "moe_decode_down_i8": nl}
        good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 4, "7", step, chunk, load_s)
        ok &= good
        launches.update({k: counts[k] for k in ("moe_decode_gate_up_i8", "moe_decode_down_i8",
                                                "fused_moe_prefill_i8", "ragged_qmatmul_i8")})
        prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="7")
        two_kernel_ms = kernel_ms(prof, "gate_up_kernel", "down_kernel")
        step_ms = sum(prof.values())
        del kv
        kv = rt.new_cache(1, PREFILL + 8)
        profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                       f"one {PREFILL}-token prefill chunk", "chunk", "7")
        del kv
        log(f"[7] MoE end to end: {time.perf_counter() - t_phase:.1f} s")
    if 14 in phases:
        t0 = time.perf_counter()
        step = {"qmatmul_i8": 2 * nl + 1, "flash_attention_decode": nl,
                "moe_decode_fused_i8": nl}
        with fused_decode_env():
            good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 14, "14", step, chunk, load_s)
            prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="14")
        ok &= good
        launches["moe_decode_fused_i8"] = counts["moe_decode_fused_i8"]
        fused_ms = kernel_ms(prof, "fused_kernel")
        log(f"[14] single-kernel decode (IK_MOE_FUSED_TG=1) at L{nl}: kernel 11 "
            f"{fused_ms:.3f} ms a step ({nl} launches), every kernel of a step "
            f"{sum(prof.values()):.3f} ms; the two-kernel step of phase 7: kernels 7 + 8 "
            + (f"{two_kernel_ms:.3f} ms, every kernel {step_ms:.3f} ms"
               if two_kernel_ms is not None else "not run")
            + f"; {time.perf_counter() - t0:.1f} s")
        del kv

    depth2(torch, rt)
    ids = [int(x) for x in np.random.default_rng(5).integers(3, v, 128)]
    if 8 in phases:
        t0 = time.perf_counter()
        tk, lk = greedy(torch, rt, ids, 16)
        with plain_path():
            tp, lp = greedy(torch, rt, ids, 16)
        err = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        tol = 5e-2 * scale
        same = tk == tp
        log(f"[8] MoE depth-2 parity, kernel path vs plain path: tokens identical over 16 "
            f"steps: {same}; logits max_abs_err {err:.3e} (max |logit| {scale:.3f}, tol "
            f"{tol:.3e} = 5% of it, the dense rule of phase 5: a one-ulp difference can "
            f"move an activation or a requantized h across an int8 step); "
            f"{time.perf_counter() - t0:.1f} s")
        if not same:
            log(f"    kernel {tk}\n    plain  {tp}")
        ok &= same and err <= tol
    if 13 in phases:
        t0 = time.perf_counter()
        reset_counts()
        with fused_decode_env():
            _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
        counts = read_counts()
        good, text = parity_verdict(lk, lp)
        good &= (counts["moe_decode_fused_i8"] == 2 * 16
                 and counts["moe_decode_gate_up_i8"] == counts["moe_decode_down_i8"] == 0)
        log(f"[13c] Qwen3-30B-A3B shape, single-kernel decode, depth 2, kernel path vs plain "
            f"path: {text}; kernel 11 launched {counts['moe_decode_fused_i8']} times, 7 and "
            f"8 never: {'ok' if good else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
        ok &= good
    del rt
    torch.cuda.empty_cache()
    return ok


def phase_q2moe(torch, gguf: Path, launches: dict, phases: set, c=Q2MOE) -> bool:
    """Phase 12 (Qwen1.5-MoE-A2.7B at full width: mixed-format experts, a
    shared expert, attention biases) and phase 13a (its parity at depth 2)
    on one loaded model."""
    from ik_llama_cpp_tpu_torch.ops.moe import QuantExpertWeights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    nl, v = c["L"], c["V"]
    t_phase = t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), nl)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    blk = rt.params["blocks"][0]
    ex = blk["experts"]
    forms = isinstance(ex, QuantExpertWeights) and (
        (ex.gate_group, ex.up_group, ex.down_group, ex.gate_s.dtype, ex.up_s.dtype,
         ex.down_s.dtype) == (256, 256, 32, torch.float32, torch.float32, torch.bfloat16)
        and tuple(ex.gate_s.shape) == (c["G"], c["E"] // 256, c["FF"])
        and tuple(ex.down_s.shape) == (c["G"], c["FF"] // 32, c["E"]))
    shared = {n: type(blk[n]).__name__ for n in ("ffn_gate_shexp", "ffn_up_shexp",
                                                 "ffn_down_shexp", "ffn_gate_inp_shexp")}
    log(f"[12] loaded {rt.cfg.arch} L{nl} E{c['E']} H{c['H']} KV{c['HKV']} D{c['D']} experts "
        f"{c['G']} top-{c['TOPK']} FF{c['FF']} shared FF{c['FFS']} V{v} in {load_s:.1f} s; "
        f"gate/up experts {tuple(ex.gate.shape)} group {ex.gate_group} scales "
        f"{tuple(ex.gate_s.shape)} {ex.gate_s.dtype}, down experts {tuple(ex.down.shape)} "
        f"group {ex.down_group} scales {tuple(ex.down_s.shape)} {ex.down_s.dtype}: as "
        f"expected {forms}; linears {_linear_kinds(rt)}, shared expert {shared}, q/k/v "
        f"unfused (biases): {'wq' in blk and 'attn_q_bias' in blk}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = forms and "wq" in blk
    if 12 in phases:
        per = 7 * nl + 1        # q, k, v, o, the shared expert's three, and the head
        step = {"qmatmul_i8": per, "flash_attention_decode": nl,
                "moe_decode_gate_up": nl, "moe_decode_down": nl}
        chunk = {"qmatmul_i8": per, "flash_attention": nl,
                 "ragged_qmatmul_i8": 2 * nl, "ragged_qmatmul": nl}
        good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 12, "12", step, chunk, load_s)
        ok &= good
        launches.update({k: counts[k] for k in ("moe_decode_gate_up", "moe_decode_down",
                                                "ragged_qmatmul")})
        profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="12")
        del kv
        kv = rt.new_cache(1, PREFILL + 8)
        profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                       f"one {PREFILL}-token prefill chunk", "chunk", "12")
        del kv
        log(f"[12] mixed-format MoE end to end: {time.perf_counter() - t_phase:.1f} s")
    if 13 in phases:
        t0 = time.perf_counter()
        depth2(torch, rt)
        ids = [int(x) for x in np.random.default_rng(13).integers(3, v, 128)]
        _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
        good, text = parity_verdict(lk, lp)
        log(f"[13a] Qwen1.5-MoE-A2.7B shape (gate/up supergroup, down planar), depth 2, kernel "
            f"path vs plain path: {text}: {'ok' if good else 'FAIL'}; "
            f"{time.perf_counter() - t0:.1f} s")
        ok &= good
    del rt
    torch.cuda.empty_cache()
    return ok


def phase_planar_moe_parity(torch, gguf: Path, c=MOE) -> bool:
    """Phase 13b: the Qwen3-30B-A3B shape loaded with the int8 path off, so
    that all three expert projections stay planar (kernels 12 and 13 every
    decode step, kernel 14 three times a prefill chunk and layer), at depth 2."""
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    weights.set_i8_mxu(False)
    try:
        rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), 2)
    finally:
        weights.set_i8_mxu(None)
    ex = rt.params["blocks"][0]["experts"]
    groups = (ex.gate_group, ex.up_group, ex.down_group)
    ids = [int(x) for x in np.random.default_rng(15).integers(3, c["V"], 128)]
    reset_counts()
    _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
    counts = read_counts()
    good, text = parity_verdict(lk, lp)
    want = {"moe_decode_gate_up": 2 * 16, "moe_decode_down": 2 * 16, "ragged_qmatmul": 3 * 2,
            "qmatmul": (2 * 2 + 1) * 17, "flash_attention": 2, "flash_attention_decode": 2 * 16}
    got = {k: n for k, n in counts.items() if n}
    good &= groups == (32, 32, 32) and got == want
    log(f"[13b] Qwen3-30B-A3B shape with the int8 path off (expert groups {groups}, linears "
        f"{_linear_kinds(rt)}), depth 2, kernel path vs plain path: {text}; launches {got}, "
        f"expected {want}: {'ok' if good else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    del rt
    torch.cuda.empty_cache()
    return good


def phase_perf_dequant(torch, launches: dict) -> bool:
    """Phase 15: the microbenchmark tool through its entry point."""
    from ik_llama_cpp_tpu_torch.tools import perf_dequant
    reset_counts()
    res = perf_dequant.main(["--reps", "10"])
    counts = read_counts()
    launches["qmatmul_pair"] = counts["qmatmul_pair"]
    ok = (set(res) == {"int8-f32s", "int8-bf16s", "int16-pair", "torch-bf16"}
          and all(us > 0 and np.isfinite(gbs) for us, gbs in res.values())
          and counts["qmatmul_pair"] > 0 and counts["qmatmul"] > 0)
    log(f"[15] tools/perf_dequant: {len(res)} variants timed; launches kernel 16 "
        f"{counts['qmatmul_pair']}, kernel D {counts['qmatmul']}: {'ok' if ok else 'FAIL'}")
    return ok


def _linear_kinds(rt) -> list:
    return sorted({type(v).__name__ for b in rt.params["blocks"] for v in b.values()
                   if hasattr(v, "forward")})


def _cache_bytes(kv) -> int:
    """Device bytes of a KVCache or MixedKVCache: every tensor field."""
    return sum(t.numel() * t.element_size() for t in vars(kv).values()
               if hasattr(t, "element_size"))


def phase_kvq(torch, gguf: Path, launches: dict) -> bool:
    """Phase 9: the full-width dense model over a quantized KV cache. The
    weights are loaded once; each configuration gets a new cache."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.runtime import kshift
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True, kv_quant="q8"), NL)
    torch.cuda.synchronize()
    log(f"[9] loaded L{NL} E{E} H{H} KV{HKV} FF{FF} V{V} with kv_quant='q8' in "
        f"{time.perf_counter() - t_phase:.1f} s; linears {_linear_kinds(rt)}")
    base_cfg = rt.cfg
    rng = np.random.default_rng(6)
    per = 4 * NL + 1
    ok = True
    mixed = {"type": "q4", "first": "q8", "last": "q8"}
    runs = [("q8", "q8", False, DECODE), ("q4", "q4", False, DECODE),
            ("q6", "q6", False, DECODE), ("nl4", "nl4", False, DECODE),
            ("q8 + khad + vhad", "q8", True, 16), (f"dict {mixed}", mixed, False, 16),
            ("bf16 (for comparison)", False, False, DECODE)]
    kv_q8 = None
    for name, quant, had, n_dec in runs:
        rt.kv_quant = quant
        rt.cfg = replace(base_cfg, k_hadamard=had, v_hadamard=had)
        ids = [int(x) for x in rng.integers(3, V, PREFILL)]
        timed_run(torch, rt, ids, 4)                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids, n_dec)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_q8 = NL if quant == "q8" else (2 if isinstance(quant, dict) else 0)
        want = dict.fromkeys(counts, 0)
        want["qmatmul_i8"] = per * (1 + n_dec)
        if quant:       # prefill: kernel 6 on q8 layers, dequantize + kernel B on the others
            want.update({"flash_attention_q8": n_q8, "flash_attention": NL - n_q8,
                         "flash_attention_decode_q8": NL * n_dec})
        else:
            want.update({"flash_attention": NL, "flash_attention_decode": NL * n_dec})
        good = counts == want
        finite = bool(torch.isfinite(logits).all())
        in_range = bool(((toks >= 0) & (toks < V)).all())
        log(f"[9] {name}: prefill {PREFILL} tokens {pre_s * 1e3:.1f} ms = "
            f"{PREFILL / pre_s:.1f} tok/s; decode {n_dec} tokens at context {PREFILL}: "
            f"{dec_s * 1e3:.1f} ms = {n_dec / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB; "
            f"cache {type(kv).__name__} capacity {kv.capacity}: {_cache_bytes(kv)} bytes")
        log(f"[9] {name}: launches { {k: v for k, v in counts.items() if v} }; "
            f"as expected: {good}; logits finite: {finite}; tokens in vocab: {in_range}")
        if not good:
            log(f"    expected { {k: v for k, v in want.items() if v} }")
        ok &= good and finite and in_range
        if quant:
            for k in ("flash_attention_decode_q8", "flash_attention_q8"):
                launches[k] = launches.get(k, 0) + counts[k]
        # the profiled steps write rows past n_past + n_dec, which stay unused
        profile_decode(torch, rt, kv, n_past + n_dec + 1, toks[:, -1:],
                       steps=8 if name == "q8" else 2, tag=f"9 {name}",
                       top=12 if name == "q8" else 0)
        if name == "q8":
            kv_q8, n_q8_past, last_tok = kv, n_past + n_dec, toks[:, -1:]
        else:
            del kv
    # K-shift on the q8 cache: drop 128 rows after the first 4, then decode on
    rt.kv_quant, rt.cfg = "q8", base_cfg
    if not kshift.can_shift(rt.cfg):
        fail("the dense llama configuration must be shiftable")
    kv_plain = copy.deepcopy(kv_q8)
    n_keep, n_discard, steps = 4, 128, 8
    before = FA.flash_attention_decode_q8.launches
    kv_q8, n1 = kshift.k_shift(kv_q8, rt.cfg, n_keep, n_discard, n_q8_past)
    lg = llama_step(torch, rt, last_tok, kv_q8, n1)
    tk, lk = greedy_from(torch, rt, kv_q8, n1 + 1, lg, steps)
    launched = FA.flash_attention_decode_q8.launches - before
    with plain_path():
        kv_plain, n2 = kshift.k_shift(kv_plain, rt.cfg, n_keep, n_discard, n_q8_past)
        lgp = llama_step(torch, rt, last_tok, kv_plain, n2)
        lp = forced_logits(torch, rt, kv_plain, n2 + 1, lgp, tk)
    err = float((lk[0] - lp[0]).abs().max())
    scale = float(lp[0].abs().max())
    _, text = parity_verdict(lk, lp)
    shift_ok = (n1 == n2 == n_q8_past - n_discard and launched == NL * (steps + 1)
                and err <= 5e-2 * scale and bool(torch.isfinite(lk).all()))
    log(f"[9] k_shift(n_keep {n_keep}, n_discard {n_discard}) on the q8 cache: n_past "
        f"{n_q8_past} -> {n1}; {steps + 1} more decode steps, kernel 5 launched {launched} "
        f"times; against the same shift and the same tokens by the plain path: first-step "
        f"logits max_abs_err {err:.3e} (max |logit| {scale:.3f}, tol 5% of it: the gate at "
        f"depth {NL}); all steps: {text}: {'ok' if shift_ok else 'FAIL'}")
    ok &= shift_ok
    del rt, kv_q8, kv_plain
    torch.cuda.empty_cache()
    log(f"[9] quantized KV end to end: {time.perf_counter() - t_phase:.1f} s")
    return ok


def llama_step(torch, rt, tok, kv, n_past):
    """One decode step of token ``tok`` (1, 1) at n_past: its logits (V,)."""
    from ik_llama_cpp_tpu_torch.models import llama
    return llama.forward(rt.params, rt.cfg, tok, kv, n_past, logits_last_only=True)[0, -1]


def _differing(torch, a, b, n: int, layer: int | None = None):
    """Share of the first n rows' K and V code bytes that differ."""
    bad = tot = 0
    layers = range(len(a.layer_map)) if hasattr(a, "layer_map") else range(a.k.shape[0])
    for i in (layers if layer is None else [layer]):
        for f in ("k", "v"):
            x, y = getattr(a, f)[i][:, :n], getattr(b, f)[i][:, :n]
            bad += int((x != y).sum())
            tot += x.numel()
    return bad / tot


def phase_kvq_parity(torch, gguf: Path) -> bool:
    """Phase 10: at depth 2, for each codec (and q8 with the Hadamard
    rotation), the kernel path against the plain path on the card."""
    from ik_llama_cpp_tpu_torch.runtime import kshift
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True, kv_quant="q8"), 2)
    base_cfg = rt.cfg
    ids = [int(x) for x in np.random.default_rng(7).integers(3, V, 128)]
    ok = True
    for name, quant, had in (("q8", "q8", False), ("q4", "q4", False), ("q6", "q6", False),
                             ("nl4", "nl4", False), ("q8 + khad + vhad", "q8", True)):
        rt.kv_quant = quant
        rt.cfg = replace(base_cfg, k_hadamard=had, v_hadamard=had)
        tk, lk, lp, kvk, kvp, nk = forced_parity(torch, rt, ids, 16)
        good, text = parity_verdict(lk, lp)
        d0, d_all = _differing(torch, kvk, kvp, nk, 0), _differing(torch, kvk, kvp, nk)
        good = good and d0 <= 1e-2
        log(f"[10] {name}, depth 2, kernel path vs plain path: {text}; cache code bytes "
            f"that differ over {nk} rows: layer 0 {100 * d0:.3f}% (its inputs differ only "
            f"by the float32 summation order of kernel A: stray steps, gate 1%), both "
            f"layers {100 * d_all:.3f}% (layer 1 sees attention outputs that differ by "
            f"bf16 ulps): {'ok' if good else 'FAIL'}")
        ok &= good
        if name == "q8":        # K-shift on both caches, then on over one history
            kvk, n1 = kshift.k_shift(kvk, rt.cfg, 4, 32, nk)
            nxt = torch.argmax(lk[-1]).reshape(1, 1)
            lg = llama_step(torch, rt, nxt, kvk, n1)
            sk, slk = greedy_from(torch, rt, kvk, n1 + 1, lg, 8)
            with plain_path():
                kvp, n2 = kshift.k_shift(kvp, rt.cfg, 4, 32, nk)
                lg = llama_step(torch, rt, nxt, kvp, n2)
                slp = forced_logits(torch, rt, kvp, n2 + 1, lg, sk)
            good, text = parity_verdict(slk, slp)
            good = good and n1 == n2 == nk - 32
            log(f"[10] q8 after k_shift(n_keep 4, n_discard 32), n_past {nk} -> {n1}, 8 more "
                f"steps: {text}: {'ok' if good else 'FAIL'}")
            ok &= good
        del kvk, kvp
    del rt
    torch.cuda.empty_cache()
    log(f"[10] quantized-KV parity: {time.perf_counter() - t0:.1f} s")
    return ok


def phase_int4(torch, gguf: Path, launches: dict) -> bool:
    """Phase 11: 4-bit packed weights at full width, then parity at depth 2."""
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = time.perf_counter()
    weights.set_pack_int4(True)
    try:
        rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    finally:
        weights.set_pack_int4(False)
    torch.cuda.synchronize()
    kinds, head = _linear_kinds(rt), type(rt.params["output"]).__name__
    luts = {v.lut16 for b in rt.params["blocks"] for v in b.values() if hasattr(v, "lut16")}
    log(f"[11] loaded L{NL} with set_pack_int4(True) in {time.perf_counter() - t_phase:.1f} s: "
        f"block linears {kinds} (codebooks {luts}: Q4_0 codes are the dense [-8, 7] range), "
        f"head {head} (Q8_0 has 255 code values: not packable); device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = kinds == ["QLinearI4"] and head == "QLinearI8"
    rng = np.random.default_rng(8)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, V, PREFILL)], 4)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches["qmatmul4"] = counts["qmatmul4"]
    want = dict.fromkeys(counts, 0)
    want.update({"qmatmul4": 4 * NL * (1 + DECODE), "qmatmul_i8": 1 + DECODE,
                 "flash_attention": NL, "flash_attention_decode": NL * DECODE})
    good = counts == want
    finite = bool(torch.isfinite(logits).all())
    in_range = bool(((toks >= 0) & (toks < V)).all())
    log(f"[11] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = {PREFILL / pre_s:.1f} tok/s; "
        f"decode {DECODE} tokens at context {PREFILL}: {dec_s * 1e3:.1f} ms = "
        f"{DECODE / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB")
    log(f"[11] launches { {k: v for k, v in counts.items() if v} }; as expected (kernel 15 "
        f"x {4 * NL} and kernel A x 1 a step and a chunk): {good}; logits finite: {finite}; "
        f"tokens in vocab: {in_range}")
    ok &= good and finite and in_range
    del kv, logits
    rt.params["blocks"] = rt.params["blocks"][:2]
    rt.cfg = replace(rt.cfg, n_layer=2)
    torch.cuda.empty_cache()
    ids = [int(x) for x in np.random.default_rng(9).integers(3, V, 128)]
    _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
    good, text = parity_verdict(lk, lp)
    log(f"[11] depth-2 parity, kernel path vs plain path: {text}: "
        f"{'ok' if good else 'FAIL'}; {time.perf_counter() - t_phase:.1f} s in all")
    del rt
    torch.cuda.empty_cache()
    return ok and good


KERNELS = {
    "qmatmul_i8": ("ik_llama_cpp_tpu_torch/csrc/qmatmul_i8.cu",
                   "ik_llama_cpp_tpu/ops/qmatmul.py:474", "M=1 K=4096 N=28672"),
    "flash_attention": ("ik_llama_cpp_tpu_torch/csrc/flash_attention.cu",
                        "ik_llama_cpp_tpu/ops/flash_attention.py:136",
                        "B=1 T=512 S=1024 q_pos0=[0] kv_len=[512]"),
    "flash_attention_decode": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_decode.cu",
                               "ik_llama_cpp_tpu/ops/flash_attention.py:770",
                               "B=1 T=1 S=1024 q_pos0=[512] kv_len=[513]"),
    "qmatmul": ("ik_llama_cpp_tpu_torch/csrc/qmatmul.cu",
                "ik_llama_cpp_tpu/ops/qmatmul.py:96", "M=1 K=4096 N=28672"),
    "moe_decode_gate_up_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_i8.cu",
                              "ik_llama_cpp_tpu/ops/moe_decode.py:392",
                              "P=8 K=2048 FF=768 G=128"),
    "moe_decode_down_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_i8.cu",
                           "ik_llama_cpp_tpu/ops/moe_decode.py:521",
                           "P=8 FF=768 E=2048 G=128"),
    "fused_moe_prefill_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm_i8.cu",
                             "ik_llama_cpp_tpu/ops/moe_qmm.py:439",
                             "G=128 R=40 K=2048 FF=768 E=2048 n_live=128"),
    "ragged_qmatmul_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm_i8.cu",
                          "ik_llama_cpp_tpu/ops/moe_qmm.py:157",
                          "M=4096 K=2048 N=768 skewed"),
    "flash_attention_decode_q8": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_decode_q.cu",
                                  "ik_llama_cpp_tpu/ops/flash_attention.py:795",
                                  "q8 B=1 T=1 S=1024 q_pos0=[512] kv_len=[513]"),
    "flash_attention_q8": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_q8.cu",
                           "ik_llama_cpp_tpu/ops/flash_attention.py:313",
                           "q8 B=1 T=512 S=1024 q_pos0=[0] kv_len=[512]"),
    "qmatmul4": ("ik_llama_cpp_tpu_torch/csrc/qmatmul4.cu",
                 "ik_llama_cpp_tpu/ops/qmatmul.py:243", "M=1 K=4096 N=28672"),
    "moe_decode_fused_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_fused_i8.cu",
                            "ik_llama_cpp_tpu/ops/moe_decode.py:686",
                            "P=8 K=2048 FF=768 E=2048 G=128"),
    "moe_decode_gate_up": ("ik_llama_cpp_tpu_torch/csrc/moe_decode.cu",
                           "ik_llama_cpp_tpu/ops/moe_decode.py:112",
                           "P=4 K=2048 FF=1408 G=60 group=256 f32 scales"),
    "moe_decode_down": ("ik_llama_cpp_tpu_torch/csrc/moe_decode.cu",
                        "ik_llama_cpp_tpu/ops/moe_decode.py:246",
                        "P=4 FF=1408 E=2048 G=60 group=32 bf16 scales"),
    "ragged_qmatmul": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm.cu",
                       "ik_llama_cpp_tpu/ops/moe_qmm.py:286",
                       "M=2048 K=1408 N=2048 G=60 group=32 random"),
    "qmatmul_pair": ("ik_llama_cpp_tpu_torch/csrc/qmatmul.cu",
                     "ik_llama_cpp_tpu/tools/perf_dequant.py:69", "M=16 K=4096 N=14336"),
}


def summary(results, launches) -> list:
    out = []
    for name, (src, repl, shape) in KERNELS.items():
        rows = results.get(name, [])
        pick = next((r for r in rows if r["case"] == shape), rows[0] if rows else None)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches.get(name, 0),
            "max_abs_err": max((r["err"] for r in rows), default=None),
            "shape": pick["case"] if pick else None,
            "ms": pick["ms"] if pick else None,
            "plain_ms": pick["plain_ms"] if pick else None,
            "bound_ms": pick["bound_ms"] if pick else None,
            "bound_by": pick["bound_by"] if pick else None,
            "library_ms": pick["library_ms"] if pick else None})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    if not (ROOT / "ik_llama_cpp_tpu_torch" / "csrc").is_dir():
        fail(f"the ik_llama_cpp_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from ik_llama_cpp_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build(_cuda)
    results, launches, ok = {}, {}, True
    timer = Timer(torch, reps=10)
    if 3 in phases:
        ok &= phase_quantizers(torch)
        ok &= phase_kernels(torch, timer, results)
        ok &= phase_moe_kernels(torch, timer, results)
        ok &= phase_kvq_kernels(torch, timer, results)
        ok &= phase_planar_moe_kernels(torch, timer, results)
    gguf = None
    if phases & {4, 5, 6, 9, 10, 11}:
        t0 = time.perf_counter()
        gguf = build_gguf(ROOT / "build" / "smoke8b.gguf")
        log(f"[4] model file ready in {time.perf_counter() - t0:.1f} s: {gguf}")
    if 4 in phases:
        ok &= phase_e2e(torch, gguf, launches)
    if 5 in phases:
        ok &= phase_parity(torch, gguf)
    if 6 in phases:
        ok &= phase_planar(torch, gguf, launches)
    if phases & {7, 8, 13, 14}:
        t0 = time.perf_counter()
        moe_gguf = build_moe_gguf(ROOT / "build" / "smoke_qwen3moe.gguf")
        log(f"[7] model file ready in {time.perf_counter() - t0:.1f} s: {moe_gguf}")
        ok &= phase_moe(torch, moe_gguf, launches, phases)
        if 13 in phases:
            ok &= phase_planar_moe_parity(torch, moe_gguf)
    if 9 in phases:
        ok &= phase_kvq(torch, gguf, launches)
    if 10 in phases:
        ok &= phase_kvq_parity(torch, gguf)
    if 11 in phases:
        ok &= phase_int4(torch, gguf, launches)
    if phases & {12, 13}:
        t0 = time.perf_counter()
        q2_gguf = build_moe_gguf(ROOT / "build" / "smoke_qwen2moe.gguf", Q2MOE)
        log(f"[12] model file ready in {time.perf_counter() - t0:.1f} s: {q2_gguf}")
        ok &= phase_q2moe(torch, q2_gguf, launches, phases)
    if 15 in phases:
        ok &= phase_perf_dequant(torch, launches)
    kernels = summary(results, launches)
    if phases >= {3, 4, 6, 7, 9, 11, 12, 14, 15}:
        for k in kernels:
            if k["launches"] <= 0:
                log(f"chip_smoke: kernel {k['name']} was never launched on its path")
                ok = False
    log(f"[16] total {time.perf_counter() - t_start:.1f} s")
    if not ok:
        fail("a phase failed (see above)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
