"""Embedding extraction CLI: the examples/embedding analogue.

The torch port of the JAX package's ``tools/embedding.py``. Each prompt
(one a ``-p`` flag, or one a line of stdin with ``-p -``) is tokenized and
embedded with ``Runtime.embed``, then normalized (common_embd_normalize:
-1 none, 0 max-abs, 2 L2, p Minkowski) and printed; ``--sim`` adds the
cosine-similarity matrix (embedding.cpp:118-205).

Usage:
    python -m ik_llama_cpp_tpu_torch.tools.embedding -m model.gguf -p "text" \
        [--pooling mean|cls|last|none] [--embd-normalize 2] [--sim] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def normalize(v: np.ndarray, p: int) -> np.ndarray:
    """common_embd_normalize (common.cpp): p -1 none, 0 max-abs, 2 L2, else
    the p-norm."""
    if p < 0:
        return v
    if p == 0:
        d = np.abs(v).max()
    elif p == 2:
        d = np.linalg.norm(v)
    else:
        d = (np.abs(v) ** p).sum() ** (1.0 / p)
    return v / d if d > 0 else v


def embed_prompts(rt, prompts: list[str], pooling: str, p: int) -> list[np.ndarray]:
    """Each prompt's embedding, normalized with ``p`` (each row's for
    pooling 'none')."""
    embs = []
    for text in prompts:
        e = np.asarray(rt.embed(rt.tokenizer.encode(text), pooling), np.float32)
        if pooling == "none":
            e = np.stack([normalize(r, p) for r in e])
        else:
            e = normalize(e, p)
        embs.append(e)
    return embs


def main(argv=None):
    ap = argparse.ArgumentParser(description="print model embeddings")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", action="append", default=[],
                    help="prompt (repeatable); '-' reads lines from stdin")
    ap.add_argument("--pooling", default="mean", choices=["mean", "cls", "last", "none"])
    ap.add_argument("--embd-normalize", type=int, default=2,
                    help="-1 none, 0 max-abs, 2 L2 (default), p Minkowski")
    ap.add_argument("--embd-output-format", default="", choices=["", "json"],
                    help="'' = plain rows, json = {object: list, data: ...}")
    ap.add_argument("--sim", action="store_true",
                    help="print the cosine-similarity matrix (multi-prompt)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from ..runtime.generate import Runtime
    rt = Runtime.from_gguf(args.model, args.device)
    prompts: list[str] = []
    for p in args.prompt:
        if p == "-":
            prompts.extend(ln.rstrip("\n") for ln in sys.stdin if ln.strip())
        else:
            prompts.append(p)
    embs = embed_prompts(rt, prompts or ["Hello world"], args.pooling, args.embd_normalize)

    if args.embd_output_format == "json":
        print(json.dumps({"object": "list",
                          "data": [{"object": "embedding", "index": i, "embedding": e.tolist()}
                                   for i, e in enumerate(embs)],
                          "model": args.model}))
    else:
        for i, e in enumerate(embs):
            flat = e.reshape(-1)
            head = " ".join(f"{x:9.6f}" for x in flat[:8])
            print(f"embedding {i}: {head}{' ...' if flat.size > 8 else ''} "
                  f"(dim={e.shape[-1]})")
    if args.sim and len(embs) > 1 and args.pooling != "none":
        print("\ncosine similarity matrix:")
        for a in embs:
            row = [float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
                   for b in embs]
            print(" ".join(f"{x:6.2f}" for x in row))


if __name__ == "__main__":
    main()
