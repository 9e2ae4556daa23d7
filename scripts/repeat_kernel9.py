#!/usr/bin/env python3
"""Count how often kernel 9 (``fused_moe_prefill_i8``) fails to repeat its
bits at the Qwen3-Next-80B-A3B shape of chip_smoke.py's row 9q (512
experts, FF 512, E 2048, capacity 16).

    python3 scripts/repeat_kernel9.py [--calls N] [--trials T]

Builds the kernels, then for each trial draws router group sizes of 5,120
rows (512 tokens, top-10) over the experts from a Dirichlet of its own
concentration (fewer or more live experts), calls the kernel once against
its plain version and N more times against that first call (an L2 flush
between every other call), and prints each trial's live experts, whether
the first call equals the plain version, how many calls differ from it, by
how much and in which slots. Card only."""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=600)
    ap.add_argument("--trials", type=int, default=4)
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
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(0)
    bad_all = 0
    for trial in range(args.trials):
        alpha = (0.2, 0.3, 0.25, 0.05)[trial % 4]
        sizes = rng.multinomial(5120, rng.dirichlet(np.full(g_, alpha)))
        r = fused_capacity(int(sizes.sum()), g_)
        xg, xst, eids, nl, n_live = C.fused_buckets(torch, sizes, g_, r, e_, gen)
        live = eids[:n_live].long()
        ref = MQ.fused_moe_prefill_i8_ref(xg, xst, eids, nl, *w, capacity=r)
        first = MQ.fused_moe_prefill_i8(xg, xst, eids, nl, *w, capacity=r)
        torch.cuda.synchronize()
        bad, slots, worst = 0, set(), 0.0
        for i in range(args.calls):
            if i % 2:
                flush.add_(1)
            out = MQ.fused_moe_prefill_i8(xg, xst, eids, nl, *w, capacity=r)
            if not torch.equal(out[live], first[live]):
                bad += 1
                d = (out[live] - first[live]).abs()
                worst = max(worst, float(d.max()))
                slots |= set(torch.nonzero(d.amax(dim=(1, 2)) > 0).flatten().tolist()[:5])
        bad_all += bad
        print(f"trial {trial}: n_live {n_live} capacity {r}: the first call equals the plain "
              f"version {torch.equal(first[live], ref[live])}; {bad} of {args.calls} calls "
              f"differ from it, by at most {worst:.4g}, in slots {sorted(slots)[:10]}",
              flush=True)
    return 1 if bad_all else 0


if __name__ == "__main__":
    sys.exit(main())
