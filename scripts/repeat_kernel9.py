#!/usr/bin/env python3
"""Count how often kernel 9 (``fused_moe_prefill_i8``) fails to repeat its
bits at the Qwen3-Next-80B-A3B shape of chip_smoke.py's row 9q (512
experts, FF 512, E 2048, capacity 16).

    python3 scripts/repeat_kernel9.py [--calls N] [--trials T] [--detail | --check [--source F]]

Builds the kernels, then for each trial draws router group sizes of 5,120
rows (512 tokens, top-10) over the experts from a Dirichlet of its own
concentration (fewer or more live experts), calls the kernel once against
its plain version and N more times against that first call, back to back
(``chip_smoke.repeat_gate``: a clean L2 flush before every other call), and
prints each trial's live experts, whether the first call equals the plain
version, how many calls differ from it, by how much and in which slots.

``--detail`` calls the C entry point itself, with scratch of its own each
call as the wrapper allocates it, and also holds each call's h scratch (the
bf16 activations, their int8 codes and scales) to the first call's: for
each slot that ever differed it prints the output rows and 256-column tiles
that differed and the h rows that did, and the indices of the calls that
differed. ``--check`` runs ``--detail``'s loop on a copy of the kernel
(``--source``, by default ``csrc/moe_qmm_i8.cu``) built under
``build/k9check/`` with checks written into it: each phase-2 item holds
its staged int8 h rows (``region``) to the global ones right after the
barrier that ends the copy and again after its down sweep, and each warp
its rows of every down tile in the TMA ring to the global codes before
its products; the first few mismatches (which check, block, item, row,
chunk) are read back after each trial. The checks' extra shared-memory
reads lengthen the stage loads' latency, and so make a stage released
before its loads land (the fault ``release_stage`` closes) far likelier
to show. Card only."""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


# the checks of --check, inserted into a copy of csrc/moe_qmm_i8.cu after
# these lines (each must occur once)
CHECK_DECL = """
__device__ int k9_check[1 + 16 * 8];
__device__ const int8_t* k9_down;
IK_DEV void k9_note(int what, int slot, int idx, int row, int ch, int sg) {
  const int n = atomicAdd(&k9_check[0], 1);
  if (n < 16) {
    int* r = k9_check + 1 + 8 * n;
    r[0] = what; r[1] = blockIdx.x; r[2] = slot; r[3] = idx; r[4] = row; r[5] = ch; r[6] = sg;
  }
}
IK_DEV void k9_region(int what, const int8_t* region, int ldh, const int8_t* hq, size_t erow,
                      int F, int rv, int tid, int slot, int idx) {
  const int cpr = F / 16;
  for (int c = tid; c < rv * cpr; c += 256) {
    const int row = c / cpr, ch = c % cpr;
    const uint4 sv = *reinterpret_cast<const uint4*>(region + row * ldh + ch * 16);
    const uint4 gv = __ldcg(reinterpret_cast<const uint4*>(hq + (erow + row) * F + ch * 16));
    if (sv.x != gv.x || sv.y != gv.y || sv.z != gv.z || sv.w != gv.w)
      k9_note(what, slot, idx, row, ch, -1);
  }
}
"""
CHECKS = [
    ("namespace fused9 {\n", CHECK_DECL),
    ("""        cp_async_commit();
        cp_async_wait<0>();
        bar_consumers();
        int part[MI][4][4];
""", """        k9_region(0, region, ldh, a.hq, erow, a.F, rv, tid, item.slot, item.idx);
"""),
    ("""            const int8_t* st = ring + s * S::BYTES + (w * 32) * BK;
""", """            {
              const int r = w * 32 + lane;
              const int8_t* gd = k9_down + ((size_t)e * a.E + item.idx * COLS + r) * a.F +
                                 (2 * sg + h2) * BK;
              for (int c = 0; c < BK / 16; ++c) {
                const uint4 sv = *reinterpret_cast<const uint4*>(
                    swz(ring + s * S::BYTES, r, c));
                const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gd + c * 16));
                if (sv.x != gv.x || sv.y != gv.y || sv.z != gv.z || sv.w != gv.w)
                  k9_note(2, item.slot, item.idx, r, c, 2 * sg + h2);
              }
            }
"""),
    ("""#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = i * 16 + g + 8 * h, col = c_w + 8 * j + 2 * t;
""", None),
]
CHECK_TAIL = """
extern "C" int ik_k9_check(int* host, const void* down) {
  if (down) {
    cudaMemcpyToSymbol(fused9::k9_down, &down, sizeof(down));
    static const int zero[1 + 16 * 8] = {0};
    cudaMemcpyToSymbol(fused9::k9_check, zero, sizeof(zero));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, fused9::k9_check, sizeof(int) * (1 + 16 * 8)));
}
"""


def build_checked(_cuda, source=None):
    """The checked copy of kernel 9's library (of ``source``, by default
    the package's ``csrc/moe_qmm_i8.cu``), loaded in place of the plain
    one; returns the check entry point."""
    import ctypes
    import subprocess
    src = Path(source or _cuda.CSRC / "moe_qmm_i8.cu").read_text()
    for anchor, add in CHECKS:
        assert src.count(anchor) == 1, anchor
        if add is None:        # the late region check, before the output stores
            add = ("        k9_region(1, region, ldh, a.hq, erow, a.F, rv, tid, item.slot, "
                   "item.idx);\n")
            src = src.replace(anchor, add + anchor)
        else:
            src = src.replace(anchor, anchor + add)
    out = _cuda.BUILD_DIR.parent / "k9check"
    out.mkdir(parents=True, exist_ok=True)
    (out / "moe_qmm_i8.cu").write_text(src + CHECK_TAIL)
    lib = out / "libmoe_qmm_i8_check.so"
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(lib),
                    str(out / "moe_qmm_i8.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    _cuda._libs["moe_qmm_i8"] = cdll
    for key in [k for k in _cuda._fns if k[0] == "moe_qmm_i8"]:
        del _cuda._fns[key]
    fn = cdll.ik_k9_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def detail_call(torch, _cuda, MQ, fn, w, xg, xst, eids, nl, r, ff, e_):
    """One kernel 9 launch as the wrapper makes it: (out, hb, hq, hs)."""
    g, _, k = xg.shape
    plan = MQ.fused_prefill_plan(r, ff, e_, g, _cuda.sm_count(xg))
    hb = torch.empty((g, r, ff), dtype=torch.bfloat16, device="cuda")
    hq = torch.empty((g, r, ff), dtype=torch.int8, device="cuda")
    hs = torch.empty((g, r, ff // 256), dtype=torch.float32, device="cuda")
    cnt = _cuda.zeroed_counters(xg.device, "fused_moe_prefill_i8", plan["counters"])
    out = torch.empty((g, r, e_), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in w]
    rc = fn(xg.data_ptr(), xst.data_ptr(), *xst.stride(), eids.data_ptr(), nl.data_ptr(),
            *ptrs, hb.data_ptr(), hq.data_ptr(), hs.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            g, r, k, ff, e_, MQ.ACTIVATIONS["silu"], 0.0, plan["mi"], plan["depth"],
            plan["blocks"], _cuda.stream_ptr(xg))
    _cuda.check(rc, "fused_moe_prefill_i8")
    return out, hb, hq, hs


def detail_trial(torch, _cuda, MQ, w, a9, n_live, r, ff, e_, calls, timer):
    """``calls`` launches held to the first, part by part; returns the
    number that differ."""
    fn = _cuda.function("moe_qmm_i8", "ik_fused_moe_prefill_i8",
                        [_cuda.P, _cuda.P] + [_cuda.I] * 3 + [_cuda.P] * 13
                        + [_cuda.I] * 6 + [_cuda.F] + [_cuda.I] * 3 + [_cuda.P])
    xg, xst, eids, nl = a9
    live = eids[:n_live].long()
    first = [t[live].clone() for t in detail_call(torch, _cuda, MQ, fn, w, *a9, r, ff, e_)]
    pat = torch.zeros((n_live, r, e_ // 256), dtype=torch.int32, device="cuda")
    hrows = torch.zeros((n_live, r, 3), dtype=torch.int32, device="cuda")
    fails = torch.zeros(calls, dtype=torch.bool, device="cuda")
    worst = torch.zeros(n_live, dtype=torch.float32, device="cuda")
    for i in range(calls):
        if i % 2:
            timer.flush.zero_()
            timer.sweep.sum()
        out, *h = detail_call(torch, _cuda, MQ, fn, w, *a9, r, ff, e_)
        diff = (out[live] - first[0]).abs()
        worst = torch.maximum(worst, diff.flatten(1).amax(1))
        d = (diff != 0).reshape(n_live, r, e_ // 256, 256).any(-1)
        pat += d.int()
        fails[i] = d.any()
        for j, (t, f) in enumerate(zip(h, first[1:])):
            hrows[..., j] += (t[live] != f).any(-1).int()
    torch.cuda.synchronize()
    bad = int(fails.sum())
    print(f"  calls that differ: {torch.nonzero(fails).flatten().tolist()[:20]}", flush=True)
    for s in torch.nonzero(pat.sum((1, 2)) + hrows.sum((1, 2))).flatten().tolist():
        rows = [torch.nonzero(hrows[s, :, j]).flatten().tolist() for j in range(3)]
        print(f"  slot {s} (expert {int(eids[s])}, by at most {float(worst[s]):.4g}): output "
              f"rows {torch.nonzero(pat[s].sum(1)).flatten().tolist()}, 256-column tiles "
              f"{torch.nonzero(pat[s].sum(0)).flatten().tolist()}; h rows that differ: bf16 "
              f"{rows[0]}, int8 {rows[1]}, scales {rows[2]}", flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=600)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--source", help="the kernel source --check instruments")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("repeat_kernel9: CUDA is not available")
    import chip_smoke as C
    from ik_llama_cpp_tpu_torch.ops import _cuda
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops.moe import fused_capacity
    t0 = time.time()
    C.phase_build(_cuda)
    print(f"build {time.time() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    c = C.QNEXT
    g_, e_, ff = c["G"], c["E"], c["FF"]
    gen = torch.Generator(device="cuda").manual_seed(9)

    def codes(n, k):
        return torch.randint(-127, 128, (g_, n, k), generator=gen, device="cuda",
                             dtype=torch.int8).transpose(1, 2)

    def scales(k, n):
        return torch.rand((g_, k // 256, n), generator=gen, device="cuda") * 2e-3 + 1e-5

    w = (codes(ff, e_), scales(e_, ff), codes(ff, e_), scales(e_, ff), codes(e_, ff),
         scales(ff, e_))
    timer = C.Timer(torch, 1)
    check = None
    if args.check:
        import ctypes
        check = build_checked(_cuda, args.source)
        _cuda.check(check(None, w[4].data_ptr()), "the checks' reset")
        print("built the checked copy of kernel 9", flush=True)
    rng = np.random.default_rng(0)
    bad_all = 0
    for trial in range(args.trials):
        alpha = (0.2, 0.3, 0.25, 0.05)[trial % 4]
        sizes = rng.multinomial(5120, rng.dirichlet(np.full(g_, alpha)))
        r = fused_capacity(int(sizes.sum()), g_)
        xg, xst, eids, nl, n_live = C.fused_buckets(torch, sizes, g_, r, e_, gen)
        live = eids[:n_live].long()
        t1 = time.time()
        if args.detail or check is not None:
            bad = detail_trial(torch, _cuda, MQ, w, (xg, xst, eids, nl), n_live, r, ff, e_,
                               args.calls, timer)
            print(f"trial {trial}: n_live {n_live} capacity {r}: {bad} of {args.calls} calls "
                  f"differ from the first ({time.time() - t1:.1f} s)", flush=True)
            bad_all += bad
            if check is not None:
                got = (ctypes.c_int * (1 + 16 * 8))()
                _cuda.check(check(ctypes.addressof(got), None), "the checks' read")
                notes = [tuple(got[1 + 8 * n:8 + 8 * n]) for n in range(min(16, got[0]))]
                print(f"  checks failed {got[0]} times; the first (check: 0 staged h after the "
                      f"copy, 1 after the sweep, 2 a down tile before its products; block, "
                      f"slot, tile, row, chunk, k stage): {notes}", flush=True)
                bad_all += got[0]
                _cuda.check(check(None, w[4].data_ptr()), "the checks' reset")
            continue
        ref = MQ.fused_moe_prefill_i8_ref(xg, xst, eids, nl, *w, capacity=r)
        first = MQ.fused_moe_prefill_i8(xg, xst, eids, nl, *w, capacity=r)
        torch.cuda.synchronize()
        bad, worst, slots = C.repeat_gate(
            torch, timer, lambda: MQ.fused_moe_prefill_i8(xg, xst, eids, nl, *w, capacity=r),
            first, live, args.calls)
        bad_all += bad
        print(f"trial {trial}: n_live {n_live} capacity {r}: the first call equals the plain "
              f"version {torch.equal(first[live], ref[live])}; {bad} of {args.calls} calls "
              f"differ from it, by at most {worst:.4g}, in live slots {slots[:10]}",
              flush=True)
    return 1 if bad_all else 0


if __name__ == "__main__":
    sys.exit(main())
