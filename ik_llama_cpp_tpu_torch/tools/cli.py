"""llama-cli equivalent: one-shot generation or an interactive REPL.

The torch port of the JAX package's ``tools/cli.py``.

Usage:
  python -m ik_llama_cpp_tpu_torch.tools.cli -m model.gguf -p "prompt" -n 64 --temp 0.7
  python -m ik_llama_cpp_tpu_torch.tools.cli -m model.gguf -i            # interactive
  python -m ik_llama_cpp_tpu_torch.tools.cli -m model.gguf -p "..." --device cpu

The model runs on the card unless ``--device`` says otherwise.
``--lookahead`` decodes with lookahead decoding (``runtime/lookahead.py``,
its default W 8, N 4, G 8). ``--prompt-cache FILE`` is main.cpp's session
file: the KV rows of the longest common prefix with the file's tokens are
restored from it instead of evaluated, and after the generation the file
holds the new state (``runtime/state.py``'s format, which the JAX CLI
reads). The layer split is a later slice of the port: asking for it
raises.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from ..runtime.generate import Runtime
from ..runtime.lookahead import generate_lookahead
from ..runtime.sampling import SamplerParams, SamplerState, sample as sample_token


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="llama-cli (torch)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("-ctk", "--cache-type",
                    choices=["bf16", "q8", "q6", "q4", "iq4_nl"], default="bf16")
    ap.add_argument("--cache-type-first", metavar="CODEC:N",
                    help="override codec for the FIRST N layers, e.g. 'q8:1'")
    ap.add_argument("--cache-type-last", metavar="CODEC:N",
                    help="override codec for the LAST N layers")
    ap.add_argument("-khad", "--k-hadamard", action="store_true",
                    help="Hadamard-rotate K (+q) before KV quantization")
    ap.add_argument("-vhad", "--v-hadamard", action="store_true",
                    help="Hadamard-rotate V before KV quantization")
    ap.add_argument("--i8-mxu", action="store_true",
                    help="int8 x int8 matmuls with activation quantization, "
                         "weights re-coded per supergroup (the default on the "
                         "card; this turns it on for the CPU too)")
    ap.add_argument("--profile-dir", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--swa-compress", action="store_true")
    ap.add_argument("--lookahead", action="store_true",
                    help="lookahead decoding (Jacobi window and n-gram pool)")
    ap.add_argument("--prompt-cache", metavar="FILE",
                    help="session file: restore the KV state if it exists, save it "
                         "after the generation")
    # a later slice of the port
    ap.add_argument("-sml", "--layer-split", type=int, default=0)
    return ap.parse_args(argv)


def kv_spec(args):
    """The KV cache type of -ctk with its --cache-type-first/-last overrides."""
    kvq = False if args.cache_type == "bf16" else args.cache_type
    if args.cache_type_first or args.cache_type_last:
        spec = {"type": args.cache_type if kvq else "q8"}
        for key, v in (("first", args.cache_type_first),
                       ("last", args.cache_type_last)):
            if v:
                codec, _, n = v.partition(":")
                spec[key] = codec
                spec["n_" + key] = int(n or 1)
        kvq = spec
    return kvq


def generate_cached(rt, prompt: str, n_predict: int, sampler: SamplerParams, seed: int,
                    capacity: int, path: str):
    """One generation through the session file at ``path``: the prompt's
    longest common prefix with the file's tokens is restored (at least one
    prompt token is evaluated), the rest evaluated, then n_predict tokens
    sampled; the file is then rewritten with every token that has a row.
    Returns (prompt ids, generated ids, tokens reused)."""
    from ..runtime.state import load_state, read_state_meta, restored_tokens, save_state
    ids = rt.tokenizer.encode(prompt)
    kv = rt.new_cache(1, capacity)
    prefix = 0
    meta = read_state_meta(path) if os.path.exists(path) else None
    if meta is not None:
        load_state(path, kv)
        for a, b in zip(restored_tokens(meta), ids):
            if a != b:
                break
            prefix += 1
        prefix = min(prefix, len(ids) - 1)
    logits, kv, n_past = rt.eval_tokens(ids[prefix:], kv, prefix)
    rng = np.random.default_rng(seed)
    state = SamplerState()
    out = []
    for _ in range(n_predict):
        tok = int(sample_token(logits[-1].cpu().numpy(), sampler, rng, history=ids + out,
                               state=state))
        out.append(tok)
        if tok == rt.eos_id:
            break
        logits, kv, n_past = rt.eval_tokens([tok], kv, n_past)
    save_state(path, (ids + out)[:n_past], n_past, kv, rows_exact=True)
    return ids, out, prefix


def main(argv=None):
    args = parse_args(argv)
    if args.i8_mxu:
        from ..models.weights import set_i8_mxu
        set_i8_mxu(True)
    t0 = time.time()
    rt = Runtime.from_gguf(args.model, args.device, kv_quant=kv_spec(args),
                           swa_compress=args.swa_compress,
                           layer_split=args.layer_split,
                           k_hadamard=args.k_hadamard, v_hadamard=args.v_hadamard)
    print(f"model loaded in {time.time() - t0:.1f}s "
          f"(arch={rt.cfg.arch}, n_layer={rt.cfg.n_layer}, "
          f"n_embd={rt.cfg.n_embd}, vocab={rt.cfg.n_vocab}, device={rt.device})",
          file=sys.stderr)
    sampler = SamplerParams(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                            min_p=args.min_p, penalty_repeat=args.repeat_penalty)
    seed = args.seed if args.seed >= 0 else int(time.time()) % 2**31

    def run(prompt: str):
        t1 = time.time()
        if args.lookahead:
            _, out, st = generate_lookahead(rt, prompt, args.n_predict, sampler=sampler,
                                            seed=seed, capacity=args.ctx_size)
            dt = time.time() - t1
            print(rt.detokenize(out))
            print(f"\n[lookahead: {len(out)} tokens, {len(out) / dt:.2f} tok/s, "
                  f"{st.n_rounds} rounds, {100 * st.accept_rate:.1f}% gram-accepted]",
                  file=sys.stderr)
            return
        if args.prompt_cache:
            ids, out, reused = generate_cached(rt, prompt, args.n_predict, sampler, seed,
                                               args.ctx_size, args.prompt_cache)
            print(f"session: reused {reused} cached tokens", file=sys.stderr)
        else:
            ids, out = rt.generate(prompt, args.n_predict, sampler, seed,
                                   capacity=args.ctx_size)
        dt = time.time() - t1
        print(rt.detokenize(out))
        print(f"\n[{len(ids)} prompt + {len(out)} generated tokens, "
              f"{len(out) / dt:.2f} tok/s]", file=sys.stderr)

    from ..runtime.timings import trace
    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with prof:
        if args.interactive:
            print("interactive mode — empty line to exit", file=sys.stderr)
            while True:
                try:
                    line = input("> ")
                except (EOFError, KeyboardInterrupt):
                    break
                if not line.strip():
                    break
                run(line)
        else:
            run(args.prompt)
    if args.profile_dir:
        print(f"profiler trace written to {args.profile_dir}/trace.json",
              file=sys.stderr)


if __name__ == "__main__":
    main()
