"""GritLM: embeddings and generation from one model, the examples/gritlm
analogue.

The torch port of the JAX package's ``tools/gritlm.py``. A GRIT model
embeds with an instruction prefix and mean-pools over the sample's tokens
only (gritlm.cpp:20-70), and generates from the same weights. The tool
embeds gritlm.cpp's documents and queries, prints their cosine
similarities, then generates.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.gritlm -m gritlm.gguf [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def gritlm_instruction(instruction: str) -> str:
    """gritlm.cpp gritlm_instruction."""
    if instruction:
        return f"<|user|>\n{instruction}\n<|embed|>\n"
    return "<|embed|>\n"


def encode_gritlm(rt, sample: str, instruction: str) -> np.ndarray:
    """The mean over the sample's token span alone (the instruction prefix
    is left out, gritlm.cpp:34-58), L2-normalized."""
    prefix_ids = rt.tokenizer.encode(gritlm_instruction(instruction))
    full_ids = prefix_ids + rt.tokenizer.encode(sample, add_bos=False)
    hid = np.asarray(rt.embed(full_ids, pooling="none"))      # (T, E)
    emb = hid[len(prefix_ids):].mean(axis=0)
    n = np.linalg.norm(emb)
    return emb / n if n > 0 else emb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from ..runtime.generate import Runtime
    rt = Runtime.from_gguf(args.model, args.device)
    # gritlm.cpp's sample texts
    instruction = "Given a scientific paper title, retrieve the paper's abstract"
    queries = ["Bitcoin: A Peer-to-Peer Electronic Cash System",
               "Generative Representational Instruction Tuning"]
    docs = [
        "A purely peer-to-peer version of electronic cash would allow online "
        "payments to be sent directly from one party to another without going "
        "through a financial institution.",
        "All text-based language problems can be reduced to either generation "
        "or embedding. Current models only perform well at one or the other.",
    ]
    d_rep = [encode_gritlm(rt, d, "") for d in docs]
    q_rep = [encode_gritlm(rt, q, instruction) for q in queries]
    for i, q in enumerate(queries):
        for j, d in enumerate(docs):
            cos = float(np.dot(q_rep[i], d_rep[j]))
            print(f'Cosine similarity between "{q[:20]}..." and "{d[:20]}..." is: {cos:.3f}')
    prompt = "<|user|>\nPlease write me a poem.\n<|assistant|>\n"
    _, out = rt.generate(prompt, args.n_predict)
    print("\n" + rt.detokenize(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
