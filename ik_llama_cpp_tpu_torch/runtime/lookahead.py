"""Lookahead decoding (lmsys Jacobi lookahead): the examples/lookahead
analogue.

The torch counterpart of the JAX package's ``runtime/lookahead.py``. A
W-column by (N - 1)-level Jacobi window and a pool, keyed by first token,
of up to G observed (N - 1)-grams (ngram_container,
examples/lookahead/lookahead.cpp:20-34). Each round evaluates one probe
block of fixed shape (the current token, G verification grams and the
window's levels) through ``Runtime.eval_probe``, with explicit positions
and the lmsys visibility mask (lookahead.cpp:182-259 builds the same
structure from multi-seq-id llama_batch entries). The probe's logits come
back to the host once a round.

The probe writes its rows into the cache from n_past on; the rows below
stay as they were. The accepted tokens are then evaluated as a plain
causal chunk at n_past, which overwrites the probe's rows with the
committed ones: the replacement for the reference's
llama_kv_cache_seq_keep cell surgery (lookahead.cpp:373-380).

The verification walk, the Jacobi shift and the n-gram harvest follow
lookahead.cpp:263-434: the window's new deepest level is the probe's argmax
at v == 0 and a copy of the shifted level otherwise; W n-grams (first
token the previous level 0) enter the pool each round.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .sampling import SamplerParams, sample as sample_token


@dataclass
class LookaheadStats:
    n_rounds: int = 0
    n_predict: int = 0
    n_accept: int = 0          # tokens accepted from verification grams

    @property
    def accept_rate(self):
        return self.n_accept / max(1, self.n_predict)


@dataclass
class _Layout:
    """The probe block's layout and visibility mask for (W, N, G): row 0 the
    current token, then G grams of N - 1 tokens, level 0's columns 1..W-1,
    then levels 1..N-2 of W columns each."""
    W: int
    N: int
    G: int
    T: int = 0
    rel_pos: np.ndarray = field(default=None)   # (T,) position - n_past
    mask: np.ndarray = field(default=None)      # (T, T) bool

    def __post_init__(self):
        W, N, G = self.W, self.N, self.G
        self.T = 1 + G * (N - 1) + (W - 1) + W * (N - 2)
        pos = np.zeros(self.T, np.int32)
        mask = np.zeros((self.T, self.T), bool)
        np.fill_diagonal(mask, True)     # each token sees itself
        mask[:, 0] = True                # the input token joins every sequence
        # verification grams: gram g's token j at n_past + 1 + j, seeing the
        # earlier tokens of its gram
        for g in range(G):
            base = 1 + g * (N - 1)
            for j in range(N - 1):
                pos[base + j] = 1 + j
                mask[base + j, base: base + j] = True
        # level 0's columns 1..W-1 (column 0's level-0 token is the input):
        # column i sees level-0 columns 1..i (lookahead.cpp:246-252)
        l0 = 1 + G * (N - 1)
        for i in range(1, W):
            pos[l0 + i - 1] = i
            mask[l0 + i - 1, l0: l0 + i] = True
        # levels 1..N-2: token (j, i) at n_past + j + i sees level-0 columns
        # 1..i and its own column's earlier levels
        lv = l0 + (W - 1)
        for j in range(1, N - 1):
            for i in range(W):
                r = lv + (j - 1) * W + i
                pos[r] = j + i
                if i >= 1:
                    mask[r, l0: l0 + i] = True
                for j2 in range(1, j):
                    mask[r, lv + (j2 - 1) * W + i] = True
        self.rel_pos = pos
        self.mask = mask

    def level_row(self, j: int, i: int) -> int:
        """The probe row of window token (level j, column i); level 0 holds
        columns 1..W-1 only."""
        l0 = 1 + self.G * (self.N - 1)
        if j == 0:
            return l0 + i - 1
        return l0 + (self.W - 1) + (j - 1) * self.W + i


def generate_lookahead(target, prompt, max_new_tokens: int = 64, *, W: int = 8, N: int = 4,
                       G: int = 8, sampler: SamplerParams | None = None, seed: int = 0,
                       capacity: int = 1024, stop_at_eos: bool = True):
    """Returns (prompt_ids, generated_ids, LookaheadStats).

    Greedy (temp 0) output is the plain decode's output: every emitted
    token is sampled from the model's logits at its position; the window
    and the grams only decide how many logit rows a probe yields. The cache
    needs room for the prompt, the tokens and one probe block."""
    sampler = sampler or SamplerParams(temp=0.0)
    ids = target._ids(prompt)
    lay = _Layout(W, N, G)
    rng = np.random.default_rng(seed)
    stats = LookaheadStats()

    kv = target.new_cache(1, capacity)
    logits, kv, n_past = target.eval_tokens(ids, kv, 0)
    out: list[int] = []

    def next_token(lg):
        return int(sample_token(lg, sampler, rng, history=ids + out))

    # the Jacobi window starts as "a sequence of increasing numbers"
    # (lookahead.cpp:139), clipped to the vocabulary
    n_vocab = logits.shape[-1]
    tokens_j = [[min(100 + i, n_vocab - 1) for i in range(W)] for _ in range(N - 1)]
    pool: dict[int, deque] = {}      # first token -> ring of (N-1)-token bodies

    cur = next_token(logits[-1].cpu().numpy())
    out.append(cur)
    stats.n_predict += 1
    eos = target.eos_id

    while len(out) < max_new_tokens and not (stop_at_eos and cur == eos):
        # the probe block
        toks = np.zeros(lay.T, np.int32)
        toks[0] = cur
        grams = list(pool.get(cur, ()))[:G]
        for g, body in enumerate(grams):
            toks[1 + g * (N - 1): 1 + (g + 1) * (N - 1)] = body
        l0 = 1 + G * (N - 1)
        toks[l0: l0 + W - 1] = tokens_j[0][1:]
        lv = l0 + (W - 1)
        for j in range(1, N - 1):
            toks[lv + (j - 1) * W: lv + j * W] = tokens_j[j]
        logits_all = target.eval_probe(toks, n_past + lay.rel_pos, lay.mask, kv,
                                       n_past).cpu().numpy()
        stats.n_rounds += 1

        # the verification walk (lookahead.cpp:263-329)
        active = list(range(len(grams)))
        accepted: list[int] = []         # the tokens emitted this round
        row = 0
        for v in range(N):
            if v > 0:
                if not active:
                    break
                row = 1 + active[0] * (N - 1) + (v - 1)
                stats.n_accept += 1
            tid = next_token(logits_all[row])
            accepted.append(tid)
            out.append(tid)
            stats.n_predict += 1
            if len(out) >= max_new_tokens or (stop_at_eos and tid == eos):
                break
            # drop the grams that disagree with the sampled token
            active = [g for g in active if grams[g][v] == tid] if v < N - 1 else []

            # the Jacobi window update (lookahead.cpp:352-377)
            tokens_j_prev = list(tokens_j[0])
            for j in range(N - 2):
                tokens_j[j] = tokens_j[j + 1]
            if v == 0:
                # the new deepest level: the argmax at each column of the
                # current deepest level; for N == 2 that is level 0, whose
                # column 0 is the probe's input (row 0)
                if N == 2:
                    rows = [0] + [lay.level_row(0, i) for i in range(1, W)]
                else:
                    rows = [lay.level_row(N - 2, i) for i in range(W)]
                tokens_j[N - 2] = [int(np.argmax(logits_all[r])) for r in rows]
            else:
                tokens_j[N - 2] = list(tokens_j[0])

            # harvest the observed n-grams (lookahead.cpp:380-434)
            if v == 0:
                for f in range(W):
                    body = tuple(tokens_j[j][f] for j in range(N - 1))
                    ring = pool.setdefault(tokens_j_prev[f], deque(maxlen=G))
                    if body not in ring:
                        ring.append(body)

        # commit: the row at n_past belongs to cur (the probe's row 0), the
        # accepted tokens follow it, and the last accepted token is the next
        # round's input
        _, kv, n_past = target.eval_tokens([cur] + accepted[:-1], kv, n_past)
        cur = accepted[-1]

    return ids, out[:max_new_tokens], stats
