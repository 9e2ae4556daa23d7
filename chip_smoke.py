#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6]

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
The line before the last lists every ported kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
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


def _record(results, kernel, case, err, tol, ms, plain_ms, lib_ms, bnd):
    ok = err <= tol
    log(f"    {kernel} {case}: max_abs_err {err:.3e} tol {tol:.3e} "
        f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'} "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
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

    def attn_case(kernel, fn, b, t, s, qpos, kvlen):
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
        case = f"B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen}"
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
    return ok


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


def clone_layers(rt, n_layer: int):
    """Block 0 cloned into n_layer distinct blocks (no aliasing)."""
    blk0 = rt.params["blocks"][0]
    rt.params["blocks"] = [copy.deepcopy(blk0) for _ in range(n_layer)]
    rt.cfg = replace(rt.cfg, n_layer=n_layer)
    return rt


def counters():
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    return {"qmatmul_i8": QM.qmatmul_i8, "flash_attention": FA.flash_attention,
            "flash_attention_decode": FA.flash_attention_decode,
            "qmatmul": QM.qmatmul}


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
    kinds = sorted({type(v).__name__ for b in rt.params["blocks"] for v in b.values()
                    if hasattr(v, "forward")} | {type(rt.params["output"]).__name__})
    log(f"[4] loaded L{NL} E{E} H{H} KV{HKV} FF{FF} V{V} in {load_s:.1f} s "
        f"(numpy planar decode + supergroup recode of one layer, then "
        f"{NL} device clones); linears {kinds}")
    rng = np.random.default_rng(1)

    def run(ids):
        kv = rt.new_cache(1, PREFILL + DECODE + 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
        first = torch.argmax(logits[-1]).reshape(1, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = rt._decode_loop(first, kv, n_past, DECODE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return logits, toks, kv, n_past, t1 - t0, t2 - t1

    run([int(x) for x in rng.integers(3, V, PREFILL)])          # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = run(ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.update({k: counts[k] for k in ("qmatmul_i8", "flash_attention",
                                            "flash_attention_decode")})
    per = 4 * NL + 1
    want = {"qmatmul_i8": per * (1 + DECODE), "flash_attention": NL,
            "flash_attention_decode": NL * DECODE, "qmatmul": 0}
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


def profile_decode(torch, rt, kv, n_past: int, tok, steps: int = 8) -> None:
    """Device time by kernel over a few decode steps (torch.profiler), and
    the share of the wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    rt._decode_loop(tok, kv, n_past, 2)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt._decode_loop(tok, kv, n_past, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    log(f"[4] profile of {steps} decode steps (under the profiler): wall "
        f"{wall * 1e3:.1f} ms, kernels {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%"
        f" busy, {100 * (1 - busy / wall):.1f}% idle), {len(rows)} kernel kinds")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"    {us / 1e3 / steps:9.3f} ms/step  {n // steps:5d} calls/step  {key[:90]}")


@contextmanager
def plain_path():
    """Route the model through the plain versions on the same tensors."""
    from ik_llama_cpp_tpu_torch.models import llama, weights
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    saved = (weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
             llama.flash_attention_decode)
    weights.qmatmul_i8, weights.qmatmul = QM.qmatmul_i8_ref, QM.qmatmul_ref
    llama.flash_attention = llama.flash_attention_decode = FA.attention_ref
    try:
        yield
    finally:
        (weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
         llama.flash_attention_decode) = saved


def greedy(torch, rt, ids, steps):
    from ik_llama_cpp_tpu_torch.models import llama
    kv = rt.new_cache(1, len(ids) + steps + 8)
    logits, kv, n = rt.eval_tokens(ids, kv, 0)
    outs, toks = [logits[-1]], []
    for s in range(steps):
        tok = int(torch.argmax(outs[-1]))
        toks.append(tok)
        lg = llama.forward(rt.params, rt.cfg,
                           torch.tensor([[tok]], device="cuda"), kv, n + s,
                           logits_last_only=True)
        outs.append(lg[0, -1])
    return toks, torch.stack(outs)


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
    kinds = sorted({type(v).__name__ for b in rt.params["blocks"] for v in b.values()
                    if hasattr(v, "forward")})
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
    ap.add_argument("--phases", default="1,2,3,4,5,6")
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
        ok &= phase_kernels(torch, timer, results)
    gguf = None
    if phases & {4, 5, 6}:
        t0 = time.perf_counter()
        gguf = build_gguf(ROOT / "build" / "smoke8b.gguf")
        log(f"[4] model file ready in {time.perf_counter() - t0:.1f} s: {gguf}")
    if 4 in phases:
        ok &= phase_e2e(torch, gguf, launches)
    if 5 in phases:
        ok &= phase_parity(torch, gguf)
    if 6 in phases:
        ok &= phase_planar(torch, gguf, launches)
    kernels = summary(results, launches)
    if phases >= {3, 4, 6}:
        for k in kernels:
            if k["launches"] <= 0:
                log(f"chip_smoke: kernel {k['name']} was never launched on its path")
                ok = False
    log(f"[7] total {time.perf_counter() - t_start:.1f} s")
    if not ok:
        fail("a phase failed (see above)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
