"""Perplexity tool — the reference's llama-perplexity protocol
(examples/perplexity/perplexity.cpp:614-780):

  * tokenize the whole text, split it into non-overlapping n_ctx chunks
  * per chunk: replace token 0 with BOS (when the model adds BOS), evaluate
    it from a fresh cache
  * NLL over positions j in [n_ctx/2, n_ctx-1): -log p(token[j+1] | ...)
  * final estimate: PPL = exp(sum nll / count), with the same running
    uncertainty estimate

The torch counterpart of the JAX package's ``tools/perplexity.py``, over
``Runtime.all_position_logits``. The log-softmax runs on the device in
float64 (the JAX tool runs it on the host in float64), so a chunk reads
back one log-probability a scored position rather than its logits; the
sums over positions run on the host in the JAX tool's order.

Usage: python -m ik_llama_cpp_tpu_torch.tools.perplexity --gguf m.gguf --text f.txt
       [--device cpu]
The model runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from ..runtime.generate import Runtime


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """float64 log-softmax over the last axis: x - (max + log sum exp(x -
    max)), the JAX tool's formula."""
    x = logits.double()
    m = x.max(dim=-1, keepdim=True).values
    return x - (m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)))


def token_logprobs(logits: torch.Tensor, ids: list[int], lo: int, hi: int) -> np.ndarray:
    """log p(ids[j + 1]) under logits[j] for j in [lo, hi), float64 on the
    host."""
    lp = log_softmax(logits[lo:hi])
    tgt = torch.as_tensor(ids[lo + 1:hi + 1], dtype=torch.int64, device=logits.device)
    return lp.gather(1, tgt[:, None])[:, 0].cpu().numpy()


def _chunks_of(rt: Runtime, tokens: list[int], n_ctx: int, n_chunks: int) -> list:
    """The first ``n_chunks`` (all, if negative) whole n_ctx chunks, each
    with BOS at its first position when the model adds BOS."""
    n_chunk_max = len(tokens) // n_ctx
    n_chunk = n_chunk_max if n_chunks < 0 else min(n_chunks, n_chunk_max)
    add_bos = rt.tokenizer.add_bos and rt.tokenizer.bos_id >= 0
    chunks = []
    for i in range(n_chunk):
        chunk = list(tokens[i * n_ctx:(i + 1) * n_ctx])
        if add_bos:
            chunk[0] = rt.tokenizer.bos_id
        chunks.append(chunk)
    return chunks


def compute_perplexity(rt: Runtime, text: str, n_ctx: int = 512,
                       n_chunks: int = -1, verbose: bool = True):
    """Returns (ppl, its uncertainty, the number of scored positions)."""
    # the reference tokenizes WITH add_special (perplexity.cpp:
    # common_tokenize(ctx, prompt, true)): for add_bos models the stream
    # starts with BOS and every chunk boundary shifts accordingly
    add_special = rt.tokenizer.add_bos and rt.tokenizer.bos_id >= 0
    tokens = rt.tokenizer.encode(text, add_bos=add_special, parse_special=False)
    chunks = _chunks_of(rt, tokens, n_ctx, n_chunks)
    if not chunks:
        raise ValueError(f"text too short: {len(tokens)} tokens < n_ctx {n_ctx}")
    first = n_ctx // 2

    nll = 0.0
    nll2 = 0.0
    count = 0
    for i, chunk in enumerate(chunks):
        logits = rt.all_position_logits(chunk, capacity=n_ctx)
        for lp in token_logprobs(logits, chunk, first, n_ctx - 1).tolist():
            nll += -lp
            nll2 += lp * lp
            count += 1
        if verbose:
            print(f"[{i + 1}]{math.exp(nll / count):.4f},", end="", flush=True,
                  file=sys.stderr)
    if verbose:
        print(file=sys.stderr)
    ppl = math.exp(nll / count)
    nll_mean = nll / count
    var = nll2 / count - nll_mean * nll_mean
    err = ppl * math.sqrt(var / count) if var > 0 else 0.0
    return ppl, err, count


def save_logits(rt: Runtime, text: str, out_path: str, n_ctx: int = 512,
                n_chunks: int = -1):
    """--kl-divergence-base: save each chunk's tokens and its full logits
    (float16) for a later KLD comparison (perplexity.cpp kl_divergence)."""
    tokens = rt.tokenizer.encode(text, add_bos=False, parse_special=False)
    chunks, logit_list = [], []
    for chunk in _chunks_of(rt, tokens, n_ctx, n_chunks):
        logits = rt.all_position_logits(chunk, capacity=n_ctx)
        chunks.append(np.asarray(chunk, np.int32))
        logit_list.append(logits.float().cpu().numpy().astype(np.float16))
    np.savez_compressed(out_path, n_ctx=n_ctx,
                        chunks=np.stack(chunks), logits=np.stack(logit_list))
    return out_path


def kl_divergence(rt: Runtime, base_path: str, verbose: bool = True):
    """KLD of this model against saved base logits (perplexity.cpp:323-378):
    mean / max / p99 KLD, the share of positions with the same top token,
    and both models' PPL."""
    data = np.load(base_path)
    n_ctx = int(data["n_ctx"])
    chunks, base_logits = data["chunks"], data["logits"]
    first = n_ctx // 2

    klds, same_top = [], []
    nll_ours = nll_base = 0.0
    count = 0
    for ci in range(len(chunks)):
        chunk = [int(t) for t in chunks[ci]]
        ours = rt.all_position_logits(chunk, capacity=n_ctx)
        lo = log_softmax(ours[first:n_ctx - 1])
        lb = log_softmax(torch.from_numpy(base_logits[ci][first:n_ctx - 1]).to(ours.device))
        tgt = torch.as_tensor(chunk[first + 1:n_ctx], dtype=torch.int64,
                              device=ours.device)[:, None]
        klds += (torch.exp(lb) * (lb - lo)).sum(dim=-1).cpu().tolist()
        same_top += (lo.argmax(-1) == lb.argmax(-1)).int().cpu().tolist()
        for a, b in zip(lo.gather(1, tgt)[:, 0].cpu().tolist(),
                        lb.gather(1, tgt)[:, 0].cpu().tolist()):
            nll_ours += -a
            nll_base += -b
            count += 1
    kld = np.asarray(klds)
    res = {
        "kld_mean": float(kld.mean()),
        "kld_max": float(kld.max()),
        "kld_p99": float(np.percentile(kld, 99)),
        "same_top_p": float(np.mean(same_top)),
        "ppl_ours": math.exp(nll_ours / count),
        "ppl_base": math.exp(nll_base / count),
    }
    if verbose:
        print(f"Mean KLD: {res['kld_mean']:.6f}  Max: {res['kld_max']:.6f}  "
              f"99%: {res['kld_p99']:.6f}")
        print(f"Same top token: {res['same_top_p'] * 100:.2f}%")
        print(f"PPL (ours/base): {res['ppl_ours']:.4f} / {res['ppl_base']:.4f}")
    return res


def hellaswag_score(rt: Runtime, tasks: list[dict], verbose: bool = True) -> float:
    """HellaSwag scoring (perplexity.cpp hellaswag_score): each task has a
    context and 4 endings; the pick is the ending with the highest
    length-normalized log-likelihood. Returns the accuracy in %.

    Task dict: {"query": str, "choices": [str x4], "gold": int}."""
    n_correct = 0
    for ti, task in enumerate(tasks):
        ctx_ids = rt.tokenizer.encode(task["query"])
        scores = []
        for choice in task["choices"]:
            full = ctx_ids + rt.tokenizer.encode(" " + choice.strip(), add_bos=False)
            logits = rt.all_position_logits(full)
            lp = 0.0
            for v in token_logprobs(logits, full, len(ctx_ids) - 1, len(full) - 1).tolist():
                lp += v
            scores.append(lp / max(len(full) - len(ctx_ids), 1))
        if int(np.argmax(scores)) == task["gold"]:
            n_correct += 1
        if verbose:
            print(f"{ti + 1}\t{100.0 * n_correct / (ti + 1):.8f}", flush=True)
    return 100.0 * n_correct / max(len(tasks), 1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ik_llama_cpp_tpu_torch.tools.perplexity")
    ap.add_argument("--gguf", required=True)
    ap.add_argument("--text", help="plain text file (e.g. wikitext-2 test)")
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=-1)
    ap.add_argument("--kl-divergence-base",
                    help="save base logits to this file and exit")
    ap.add_argument("--kl-divergence",
                    help="compute KLD against a saved base logits file")
    ap.add_argument("--hellaswag", help="JSONL tasks file: query/choices/gold")
    ap.add_argument("--hellaswag-tasks", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    rt = Runtime.from_gguf(args.gguf, args.device)
    if args.kl_divergence:
        kl_divergence(rt, args.kl_divergence)
        return
    if args.hellaswag:
        import json
        with open(args.hellaswag) as f:
            tasks = [json.loads(line) for line in f][: args.hellaswag_tasks]
        acc = hellaswag_score(rt, tasks)
        print(f"hellaswag accuracy: {acc:.4f}%")
        return
    with open(args.text, encoding="utf-8") as f:
        text = f.read()
    if args.kl_divergence_base:
        save_logits(rt, text, args.kl_divergence_base, args.n_ctx, args.chunks)
        print(f"saved base logits -> {args.kl_divergence_base}")
        return
    ppl, err, count = compute_perplexity(rt, text, args.n_ctx, args.chunks)
    print(f"Final estimate: PPL = {ppl:.4f} +/- {err:.5f}")
    return ppl


if __name__ == "__main__":
    main()
