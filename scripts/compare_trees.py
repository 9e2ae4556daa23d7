#!/usr/bin/env python3
"""Compare two trees' MoE kernels 7 and 10 on one card, one process a tree.

    python3 scripts/compare_trees.py save --tree DIR --out FILE
    python3 scripts/compare_trees.py compare FILE_A FILE_B
    python3 scripts/compare_trees.py time10p --tree DIR --sizes FILE

``save`` imports ``ik_llama_cpp_tpu_torch`` from the checkout DIR (its
kernels build into DIR/build/kernels), runs ``moe_decode_gate_up_i8``
(kernel 7) and ``ragged_qmatmul_i8`` (kernel 10) on the card over inputs
made from fixed seeds (the Qwen3-30B-A3B and Qwen1.5-MoE-A2.7B shapes,
several group-size sets, biases and activations) and saves their outputs
(kernel 10: the live rows only). ``compare`` prints, as one JSON line, for
each case whether the two files hold the same bits, and exits non-zero if
any differ. Run ``save`` once for each tree, each in its own process, on
one card. ``time10p`` times the tree's kernel 10 at row 10p of
chip_smoke.py (the overflow of kernel 9's buckets at the router's group
sizes that phase 7 writes to build/qwen3moe_router_sizes.json, on the
same seeded inputs and timing loop as chip_smoke.phase_replay_10p, from
this checkout's chip_smoke.py): layer 0's gate call and every layer's three
calls, each timed alone after a clean L2 flush, printed as one JSON line
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cases(torch, MD, MQ):
    """{name: output} over seeded inputs on the card."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}

    def codes(g, n, k):       # (G, K, N) view of a contiguous (G, N, K) tensor
        return torch.randint(-127, 128, (g, n, k), generator=gen, device=dev,
                             dtype=torch.int8).transpose(1, 2)

    def scales(g, k, n):
        return torch.rand((g, k // 256, n), generator=gen, device=dev) * 2e-3 + 1e-5

    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    for g, k, ff, p, bias, act, limit in [(128, 2048, 768, 8, False, "silu", 0.0),
                                          (128, 2048, 768, 64, False, "silu", 0.0),
                                          (60, 2048, 1408, 4, True, "silu", 0.0),
                                          (60, 2048, 1408, 32, True, "gelu", 0.0),
                                          (16, 1024, 352, 16, True, "silu", 7.0),
                                          (8, 2816, 2880, 8, True, "swiglu_oai", 0.0)]:
        gate, up = codes(g, ff, k), codes(g, ff, k)
        gsw, usw = scales(g, k, ff), scales(g, k, ff)
        gb = torch.randn((g, ff), generator=gen, device=dev) if bias else None
        ub = torch.randn((g, ff), generator=gen, device=dev) if bias else None
        ids = torch.randint(0, g, (p,), generator=gen, device=dev, dtype=torch.int32)
        xq, xs = quantize_activations(torch.randn((p, k), generator=gen, device=dev))
        out[f"7 P={p} K={k} FF={ff} G={g} {act} limit={limit} bias={bias}"] = \
            MD.moe_decode_gate_up_i8(xq, xs.t(), ids, gate, gsw, up, usw, gb, ub,
                                     activation=act, act_limit=limit)
    rng = np.random.default_rng(15)
    for g, k, n, m in [(128, 2048, 768, 4096), (128, 768, 2048, 4096), (60, 2048, 1408, 2048)]:
        w, sw = codes(g, n, k), scales(g, k, n)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand((m, k // 256), generator=gen, device=dev) * 1e-2 + 1e-4
        harm = 1.0 / np.arange(1, g + 1)
        few = np.zeros(g, np.int64)
        few[rng.permutation(g)[:40]] = rng.multinomial(m - 700, np.full(40, 1 / 40))
        for name, sizes in {"skewed": rng.permutation(rng.multinomial(m, harm / harm.sum())),
                            "random": rng.multinomial(m, np.full(g, 1.0 / g)),
                            "mid-tile": np.full(g, m // g), "40 live": few}.items():
            gs = torch.from_numpy(sizes.astype(np.int32)).to(dev)
            live = int(sizes.sum())
            out[f"10 M={m} K={k} N={n} G={g} {name}"] = \
                MQ.ragged_qmatmul_i8(xq, xs.t(), w, sw, gs)[:live]
    torch.cuda.synchronize()
    return {name: t.cpu() for name, t in out.items()}


def time10p(torch, sizes: list, tree: Path) -> dict:
    """Row 10p's timings of the tree's kernel 10, on the inputs and with
    the timing loop of this checkout's chip_smoke.py (replay_10p_inputs,
    time_10p_layers)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(      # this checkout's, whatever tree is timed
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    _, _, over, calls = CS.replay_10p_inputs(torch, sizes)
    timer = CS.Timer(torch, reps=10)
    xq, xs, w, sw = calls[0]
    gs0 = torch.from_numpy(over[0].astype(np.int32)).cuda()
    layer0 = timer(lambda: MQ.ragged_qmatmul_i8(xq, xs.t(), w, sw, gs0))
    total = CS.time_10p_layers(torch, timer, over, calls)
    smi = CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True)
    return {"tree": str(tree), "package": MQ.__file__, "layer0_ms": layer0,
            "all_layers_ms": total, "calls": 3 * len(over),
            "rows_past_capacity_layer0": int(over[0].sum()), "card": smi.stdout.strip()}


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("--tree", required=True, type=Path)
    s.add_argument("--out", required=True, type=Path)
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    t = sub.add_parser("time10p")
    t.add_argument("--tree", required=True, type=Path)
    t.add_argument("--sizes", required=True, type=Path)
    args = ap.parse_args()
    import torch
    if args.cmd == "time10p":
        if not torch.cuda.is_available():
            print("compare_trees: CUDA is not available", file=sys.stderr)
            return 2
        sys.path.insert(0, str(args.tree.resolve()))
        print(json.dumps(time10p(torch, json.loads(args.sizes.read_text()), args.tree)))
        return 0
    if args.cmd == "save":
        if not torch.cuda.is_available():
            print("compare_trees: CUDA is not available", file=sys.stderr)
            return 2
        sys.path.insert(0, str(args.tree.resolve()))
        from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
        from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.save(cases(torch, MD, MQ), args.out)
        print(f"compare_trees: saved {args.out} from {MD.__file__}")
        return 0
    a, b = torch.load(args.a), torch.load(args.b)
    same = {k: bool(k in b and torch.equal(a[k], b[k])) for k in a}
    print(json.dumps({"same_bits": same, "all": all(same.values()) and a.keys() == b.keys()}))
    return 0 if all(same.values()) and a.keys() == b.keys() else 1


if __name__ == "__main__":
    sys.exit(main())
