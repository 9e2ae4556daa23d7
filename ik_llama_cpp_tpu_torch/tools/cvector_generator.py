"""Control-vector generator CLI: the examples/cvector-generator analogue.

The torch port of the JAX package's ``tools/cvector_generator.py``.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.cvector_generator -m model.gguf \
      --positive-file pos.txt --negative-file neg.txt -o control.gguf \
      [--method pca|mean] [--device cpu]

pos.txt / neg.txt: one prompt a line, paired by line number.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..runtime.cvector import generate_control_vector, write_control_vector
from ..runtime.generate import Runtime


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--positive-file", required=True)
    ap.add_argument("--negative-file", required=True)
    ap.add_argument("-o", "--out", default="control_vector.gguf")
    ap.add_argument("--method", choices=["pca", "mean"], default="pca")
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    pos = [ln for ln in Path(args.positive_file).read_text().splitlines() if ln.strip()]
    neg = [ln for ln in Path(args.negative_file).read_text().splitlines() if ln.strip()]
    n = min(len(pos), len(neg))
    if n == 0:
        raise SystemExit("need at least one positive/negative prompt pair")
    rt = Runtime.from_gguf(args.model, args.device)
    directions = generate_control_vector(rt, pos[:n], neg[:n], method=args.method)
    p = write_control_vector(args.out, directions)
    print(f"wrote {p} ({directions.shape[0]} layers x {directions.shape[1]} dims)")


if __name__ == "__main__":
    main()
