"""Chunked-document retrieval: the examples/retrieval analogue.

The torch port of the JAX package's ``tools/retrieval.py``. Files are
split on a separator into chunks (retrieval.cpp chunk_file), every chunk
is embedded (``Runtime.embed``, L2-normalized), and the chunks are ranked
by cosine similarity against each query's embedding.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.retrieval --gguf m.gguf \
      --context-file doc.txt --chunk-size 100 --top-k 3 --query "..." [--device cpu]
(without --query, the queries are read from stdin, one a line)
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np


@dataclass
class Chunk:
    filename: str
    pos: int
    text: str
    embedding: np.ndarray | None = None


def chunk_file(path: str, chunk_size: int, separator: str) -> list[Chunk]:
    """retrieval.cpp chunk_file: separator-delimited pieces accumulate until
    a chunk holds at least chunk_size characters; then a new one starts."""
    out: list[Chunk] = []
    with open(path, errors="replace") as f:
        text = f.read()
    cur, start, pos = "", 0, 0
    for piece in text.split(separator):
        cur += piece + separator
        pos += len(piece) + len(separator)
        if len(cur) >= chunk_size:
            out.append(Chunk(path, start, cur))
            cur, start = "", pos
    if cur.strip():
        out.append(Chunk(path, start, cur))
    return out


def embed_texts(rt, texts: list[str], pooling: str = "mean") -> np.ndarray:
    """(N, E) L2-normalized embeddings."""
    out = []
    for t in texts:
        e = np.asarray(rt.embed(rt.tokenizer.encode(t), pooling))
        n = np.linalg.norm(e)
        out.append(e / n if n > 0 else e)
    return np.stack(out)


def rank(chunk_emb: np.ndarray, query_emb: np.ndarray, top_k: int) -> list[tuple[int, float]]:
    """The top_k chunks by similarity: [(index, similarity)], best first."""
    sims = chunk_emb @ query_emb
    order = np.argsort(-sims)[:top_k]
    return [(int(i), float(sims[i])) for i in order]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gguf", "-m", required=True)
    ap.add_argument("--context-file", action="append", default=[], required=True)
    ap.add_argument("--chunk-size", type=int, default=100)
    ap.add_argument("--chunk-separator", default="\n")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--query", help="one-shot query (else read from stdin)")
    ap.add_argument("--pooling", default="mean", choices=["mean", "cls", "last"])
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from ..runtime.generate import Runtime
    rt = Runtime.from_gguf(args.gguf, args.device)
    chunks: list[Chunk] = []
    for f in args.context_file:
        chunks.extend(chunk_file(f, args.chunk_size, args.chunk_separator))
    print(f"embedding {len(chunks)} chunks...", file=sys.stderr)
    emb = embed_texts(rt, [c.text for c in chunks], args.pooling)

    def answer(q: str):
        qe = embed_texts(rt, [q], args.pooling)[0]
        for i, sim in rank(emb, qe, args.top_k):
            c = chunks[i]
            print(f"[{sim:.4f}] {c.filename}:{c.pos}\n{c.text.strip()}\n")

    if args.query is not None:
        answer(args.query)
        return 0
    for line in sys.stdin:
        if line.strip():
            answer(line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
