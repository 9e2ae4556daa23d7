"""Lookahead-decoding CLI: the examples/lookahead analogue.

The torch port of the JAX package's ``tools/lookahead.py``.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.lookahead -m model.gguf -p "prompt" -n 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", required=True)
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-W", "--window", type=int, default=8, help="lookahead window width")
    ap.add_argument("-N", "--ngram", type=int, default=4, help="n-gram size (levels = N-1)")
    ap.add_argument("-G", "--n-verify", type=int, default=8,
                    help="max verification n-grams per step")
    ap.add_argument("-c", "--ctx", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from ..runtime.generate import Runtime
    from ..runtime.lookahead import generate_lookahead
    from ..runtime.sampling import SamplerParams

    rt = Runtime.from_gguf(args.model, args.device)
    t0 = time.perf_counter()
    _, out, st = generate_lookahead(rt, args.prompt, args.n_predict, W=args.window,
                                    N=args.ngram, G=args.n_verify,
                                    sampler=SamplerParams(temp=args.temp), seed=args.seed,
                                    capacity=args.ctx)
    dt = time.perf_counter() - t0
    print(rt.detokenize(out))
    print(f"\nn_predict = {st.n_predict}, rounds = {st.n_rounds}, accepted = {st.n_accept} "
          f"({100 * st.accept_rate:.1f}%), {len(out) / dt:.2f} t/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
