"""Speculative decoding — the analogue of common/speculative.cpp.

The torch port of the JAX package's ``runtime/speculative.py``. Stages:
  * ngram, suffix, ngram-map, ngram-mod, ngram-cache: self-speculation from
    the sequence itself (the reference's lookup stages); host Python
  * draft: a second, smaller ``Runtime`` proposes n_draft tokens
  * mtp: the model's own trailing NextN/MTP layer drafts from the main
    model's pre-output-norm hidden states (``_generate_mtp``)
  * eagle3: selectable and never proposes, as in the reference

The target verifies [last token | draft] in one forward of width
W = 1 + n_draft. Acceptance is greedy token match against the target's
argmax (temperature 0); a sampler that is not exactly argmax takes the
host loop, which samples every position from the read-back logits.

A recurrent model (the delta-net and mamba families) keeps a copy of its
conv tails and recurrent states before each verify (``HybridCache`` /
``MambaCache.checkpoint``): its cache is written in place, where the JAX
package keeps the pre-verify cache by reference. On partial acceptance it
restores the copy and replays the accepted prefix. Such a model takes the
host loop always; the device loop (``Runtime._spec_loop``) refuses it, as
the JAX runtime's does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.llama import _later
from .generate import PREFILL_BUCKETS, Runtime, ngram_hash
from .sampling import SamplerParams, sample as sample_token


@dataclass
class SpecStats:
    n_draft: int = 0
    n_accept: int = 0
    n_rounds: int = 0

    @property
    def accept_rate(self):
        return self.n_accept / max(self.n_draft, 1)


class NgramDraft:
    """Prompt-lookup drafting (ngram cache over the current sequence)."""

    def __init__(self, n_min: int = 2, n_max_ngram: int = 4):
        self.n_min = n_min
        self.n_max_ngram = n_max_ngram

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        seq = tokens
        for ng in range(self.n_max_ngram, self.n_min - 1, -1):
            if len(seq) < ng + 1:
                continue
            suffix = tuple(seq[-ng:])
            # search the most recent earlier occurrence
            for start in range(len(seq) - ng - 1, -1, -1):
                if tuple(seq[start:start + ng]) == suffix:
                    cont = seq[start + ng:start + ng + n_draft]
                    if cont:
                        return list(cont)
                    break
        return []


class SuffixDraft:
    """Longest-suffix-match drafting — the reference's suffix-tree stage
    (common/suffix-tree.cpp): find the earlier position whose preceding
    context shares the LONGEST suffix with the current position, propose
    what followed it. Unbounded match length (vs NgramDraft's fixed n)."""

    def __init__(self, n_min: int = 1, max_scan: int = 4096):
        self.n_min = n_min
        self.max_scan = max_scan
        # positions of each token, for the candidate lookup
        self._pos: dict[int, list[int]] = {}
        self._fed = 0

    def _feed(self, tokens: list[int]):
        for i in range(self._fed, len(tokens)):
            self._pos.setdefault(tokens[i], []).append(i)
        self._fed = len(tokens)

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        self._feed(tokens)
        n = len(tokens)
        if n < self.n_min + 1:
            return []
        last = tokens[-1]
        best_len, best_j = 0, -1
        cands = self._pos.get(last, [])
        for j in reversed(cands[-self.max_scan:]):
            if j == n - 1:
                continue
            # match length of the suffix ending at j vs the one ending at n-1
            m = 1
            while m <= j and tokens[j - m] == tokens[n - 1 - m]:
                m += 1
            if m > best_len:
                best_len, best_j = m, j
        if best_len < self.n_min or best_j < 0:
            return []
        return tokens[best_j + 1: best_j + 1 + n_draft]


class NgramMapDraft:
    """Frequency-weighted n-gram map drafting — the reference's ngram-map-k
    stage (common/ngram-map.cpp): counts of what followed each n-gram, and
    the historically most frequent continuation chain proposed."""

    def __init__(self, n: int = 3):
        self.n = n
        self.counts: dict[tuple, dict[int, int]] = {}
        self._fed = 0

    def update(self, tokens: list[int]):
        n = self.n
        for i in range(max(self._fed - n, 0), len(tokens) - n):
            key = tuple(tokens[i:i + n])
            nxt = tokens[i + n]
            d = self.counts.setdefault(key, {})
            d[nxt] = d.get(nxt, 0) + 1
        self._fed = len(tokens)

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        self.update(tokens)
        out: list[int] = []
        seq = list(tokens)
        for _ in range(n_draft):
            key = tuple(seq[-self.n:])
            d = self.counts.get(key)
            if not d:
                break
            nxt = max(d, key=d.get)
            out.append(nxt)
            seq.append(nxt)
        return out


class NgramModDraft:
    """Fixed-size modular-hash n-gram table — the reference's ngram_mod
    stage (common/ngram-mod.cpp + speculative.cpp
    common_speculative_state_ngram_mod): one open-addressed array indexed
    by the 6364136223846793005 multiplicative hash of the last n tokens,
    storing the following token, with the reference's occupancy reset
    (>25% after the prompt feed) and low-acceptance streak reset (3 rounds
    under 50%)."""

    EMPTY = -1
    MUL = 6364136223846793005

    def __init__(self, n: int = 4, size: int = 1 << 16, n_min: int = 1):
        self.n = n
        self.n_min = n_min
        self.entries = [self.EMPTY] * size
        self.used = 0
        self._i_last = 0
        self._n_draft_last = 0
        self._n_low = 0

    def _idx(self, toks) -> int:
        res = 0
        for t in toks:
            res = (res * self.MUL + t) & 0xFFFFFFFFFFFFFFFF
        return res % len(self.entries)

    def _add(self, window):
        i = self._idx(window[:self.n])
        if self.entries[i] == self.EMPTY:
            self.used += 1
        self.entries[i] = window[self.n]

    def reset(self):
        self.entries = [self.EMPTY] * len(self.entries)
        self.used = 0
        self._i_last = 0
        self._n_low = 0

    def begin(self, prompt: list[int]):
        self._i_last = 0
        self._n_draft_last = 0
        self._n_low = 0
        if len(prompt) < self.n:
            return
        for i in range(len(prompt) - self.n):
            self._add(prompt[i:i + self.n + 1])
        self._i_last = len(prompt) - self.n
        if self.used > 0.25 * len(self.entries):
            self.reset()

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        self._n_draft_last = 0
        cur_len = len(tokens)
        if cur_len < self.n:
            return []
        # add new n-grams in chunks of >= 32 (speculative.cpp:815-821)
        if self._i_last + 32 < cur_len:
            for i in range(self._i_last, cur_len - self.n):
                self._add(tokens[i:i + self.n + 1])
            self._i_last = cur_len - self.n
        seq = list(tokens[-self.n:])
        out: list[int] = []
        for i in range(n_draft):
            t = self.entries[self._idx(seq[-self.n:])]
            if t == self.EMPTY:
                if i < self.n_min:
                    return []
                break
            out.append(t)
            seq.append(t)
        self._n_draft_last = len(out)
        return out

    def accept(self, n_accepted: int):
        if self._n_draft_last > 0:
            if n_accepted < 0.5 * self._n_draft_last:
                self._n_low += 1
                if self._n_low >= 3:
                    self.reset()
            else:
                self._n_low = 0


class NgramCacheDraft:
    """3-tier validated n-gram cache — the reference's ngram_cache stage
    (common/ngram-cache.cpp common_ngram_cache_draft): a context cache
    built from the live sequence, an optional dynamic cache persisted
    across requests, and an optional static corpus cache. Context drafts
    use strict sample-size/percent thresholds validated against the static
    part; dynamic drafts use the lax thresholds; the static-only fallback
    drafts the majority token."""

    NGRAM_MIN, NGRAM_MAX, NGRAM_STATIC = 1, 4, 2
    MIN_SIZE_LAX = [2, 2, 1, 1]
    MIN_PCT_LAX = [66, 50, 50, 50]
    MIN_SIZE_STRICT = [4, 3, 2, 2]
    MIN_PCT_STRICT = [75, 66, 66, 66]

    def __init__(self, static_cache=None, dynamic_cache=None):
        self.ctx: dict[tuple, dict[int, int]] = {}
        self.dyn: dict[tuple, dict[int, int]] = dynamic_cache or {}
        self.static: dict[tuple, dict[int, int]] = static_cache or {}
        self._fed = 0

    @staticmethod
    def update_cache(cache, tokens, ngram_min, ngram_max, nnew):
        size = len(tokens)
        for ng in range(ngram_min, ngram_max + 1):
            for i in range(max(size - nnew, ng), size):
                key = tuple(tokens[i - ng:i])
                part = cache.setdefault(key, {})
                part[tokens[i]] = part.get(tokens[i], 0) + 1

    def _try_static(self, ngram):
        part = self.static.get(ngram)
        if not part:
            return None
        tot = sum(part.values())
        tok, cnt = max(part.items(), key=lambda kv: kv[1])
        if tot < self.MIN_SIZE_LAX[self.NGRAM_STATIC - 1]:
            return None
        if 100 * cnt < self.MIN_PCT_LAX[self.NGRAM_STATIC - 1] * tot:
            return None
        return tok

    def _try_primary(self, cache, ngrams, part_static, min_size, min_pct):
        for i in reversed(range(len(ngrams))):
            part = cache.get(ngrams[i])
            if not part:
                continue
            best_tok, best_p, best_s, total = None, 0, 0, 0
            for tok, cp in part.items():
                cs = 100 * part_static.get(tok, 0) or 1
                if cp * cs > best_p * best_s:
                    best_tok, best_p, best_s = tok, cp, cs
                total += cp
            if total < min_size[i]:
                continue
            if 100 * best_p < min_pct[i] * total:
                continue
            return best_tok
        return None

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        self.update_cache(self.ctx, tokens, self.NGRAM_MIN, self.NGRAM_MAX,
                          len(tokens) - self._fed)
        self._fed = len(tokens)
        if len(tokens) < self.NGRAM_STATIC:
            return []
        seq = list(tokens)
        out: list[int] = []
        while len(out) < n_draft:
            ng_static = tuple(seq[-self.NGRAM_STATIC:])
            part_static = self.static.get(ng_static, {})
            ngrams = [tuple(seq[-n:]) for n in
                      range(self.NGRAM_MIN, self.NGRAM_MAX + 1)
                      if len(seq) >= n]
            tok = self._try_primary(self.ctx, ngrams, part_static,
                                    self.MIN_SIZE_STRICT, self.MIN_PCT_STRICT)
            if tok is None:
                tok = self._try_primary(self.dyn, ngrams, part_static,
                                        self.MIN_SIZE_LAX, self.MIN_PCT_LAX)
            if tok is None:
                tok = self._try_static(ng_static)
            if tok is None:
                break
            out.append(tok)
            seq.append(tok)
        return out

    def accept(self, n_accepted: int):
        """Round feedback hook (the drafters' common protocol); the dynamic
        cache persists through feed_dynamic, as the reference server's
        common_ngram_cache_update-on-accept path does."""

    def feed_dynamic(self, accepted_tokens: list[int]):
        """Fold an accepted continuation into the dynamic cache."""
        self.update_cache(self.dyn, accepted_tokens, self.NGRAM_MIN,
                          self.NGRAM_MAX, len(accepted_tokens))


class Eagle3Draft:
    """The EAGLE3 stage as the reference has it: its
    common_speculative_state_eagle3::draft is `// TODO: implement`
    (common/speculative.cpp:668-692), so the stage is selectable and never
    proposes tokens."""

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        return []


class DFlashDraft:
    """DFlash block-diffusion drafting needs the dflash draft model's
    forward: a later slice."""

    def __init__(self, *args, **kwargs):
        _later("DFlash drafting (the dflash draft model)", "other architectures (item 8)")


class ReplayDraft:
    """Oracle/replay drafter: proposes a KNOWN continuation (the model's own
    greedy output captured beforehand, or a forced script). With a perfect
    draft the accept rate must be 100%, which makes it a gate on the
    verify machinery, and its ceiling."""

    def __init__(self, prompt_len: int, continuation: list[int]):
        self.prompt_len = prompt_len
        self.continuation = list(continuation)

    def propose(self, tokens: list[int], n_draft: int) -> list[int]:
        pos = len(tokens) - self.prompt_len
        if pos < 0:
            return []
        return self.continuation[pos:pos + n_draft]


DRAFTERS = {"ngram": NgramDraft, "suffix": SuffixDraft, "ngram-map": NgramMapDraft,
            "ngram-mod": NgramModDraft, "ngram-cache": NgramCacheDraft,
            "eagle3": Eagle3Draft}


def _drafter(stage):
    """A drafter instance as given, or a new one of the named stage (an
    unknown name drafts with NgramDraft, as the JAX package does)."""
    if not isinstance(stage, str):
        return stage
    return DRAFTERS.get(stage, NgramDraft)()


def _greedy_sampler(sp: SamplerParams) -> bool:
    """True when sampling is exactly argmax(raw logits): temperature 0 and
    no stage that can displace the top-1 candidate."""
    return (sp.temp <= 0.0 and sp.penalty_repeat == 1.0
            and sp.penalty_freq == 0.0 and sp.penalty_present == 0.0
            and sp.dry_multiplier == 0.0 and not sp.logit_bias
            and sp.mirostat == 0 and sp.xtc_probability == 0.0
            and sp.adaptive_target < 0)


def _generate_spec_greedy(target: Runtime, ids, max_new_tokens, *, drafter,
                          n_draft, capacity, stop_at_eos, stats,
                          draft: Optional[Runtime] = None):
    """The greedy speculative loop: one verify forward a round
    (``Runtime._spec_verify``), W ints read back."""
    eos = target.eos_id
    w = 1 + n_draft
    kv = target.new_cache(1, capacity + w + PREFILL_BUCKETS[0])
    logits, kv, n_past = target.eval_tokens(ids, kv, 0)
    out = [int(torch.argmax(logits[-1]))]
    step = target._spec_verify(w)

    d_kv = d_n_past = None
    if draft is not None:
        d_kv = draft.new_cache(1, capacity + w + PREFILL_BUCKETS[0])
        _, d_kv, d_n_past = draft.eval_tokens(ids, d_kv, 0)

    block = torch.zeros((1, w), dtype=torch.int64)
    while len(out) < max_new_tokens:
        cur = out[-1]
        if stop_at_eos and cur == eos:
            break
        if n_past + w >= kv.capacity:
            break                       # the caller re-enters with a shift
        if draft is not None:
            # the draft model's catch-up step, then its device decode loop of
            # n_draft steps: the draft cache takes a row for every proposed
            # token, so a fully accepted round leaves it aligned
            dl, d_kv, d_n_past = draft.eval_tokens([cur], d_kv, d_n_past)
            first = torch.argmax(dl[-1]).reshape(1, 1)
            toks = draft._decode_loop(first, d_kv, d_n_past, n_draft)
            proposal = torch.cat([first[0], toks[0]]).tolist()[:n_draft]
            d_n_past += n_draft
        else:
            proposal = list(drafter.propose(ids + out, n_draft))[:n_draft]
        stats.n_rounds += 1
        stats.n_draft += len(proposal)

        block[0, 0] = cur
        block[0, 1:] = 0
        if proposal:
            block[0, 1:1 + len(proposal)] = torch.as_tensor(proposal, dtype=torch.int64)
        preds = step(block, kv, n_past)[0].tolist()    # W ints: the whole readback
        n_acc = 0
        while (n_acc < len(proposal) and preds[n_acc] == proposal[n_acc]
               and (not stop_at_eos or proposal[n_acc] != eos)):
            n_acc += 1
        stats.n_accept += n_acc
        if hasattr(drafter, "accept"):
            drafter.accept(n_acc)
        emitted = list(proposal[:n_acc]) + [int(preds[n_acc])]
        out.extend(emitted)
        n_past += 1 + n_acc
        if draft is not None:
            d_n_past -= len(proposal) - n_acc
        if stop_at_eos and eos in emitted:
            break

    out = out[:max_new_tokens]
    if stop_at_eos and eos in out:
        out = out[:out.index(eos) + 1]
    return ids, out, stats


def _ngram_mod_prefeed(tokens, *, n: int, table_bits: int) -> np.ndarray:
    """Host-side table prefeed of the device ngram drafter: every (n-gram
    -> next token) of the prompt, at ``Runtime._spec_loop``'s slots
    (``ngram_hash``)."""
    table = np.full((1 << table_bits,), -1, np.int32)
    for p in range(n, len(tokens)):
        table[ngram_hash([int(t) for t in tokens[p - n:p]], table_bits)] = tokens[p]
    return table


def generate_speculative_device(
    target: Runtime,
    prompt,
    max_new_tokens: int = 64,
    *,
    n_draft: int = 8,
    rounds_per_call: int = 8,
    capacity: int = 1024,
    stop_at_eos: bool = True,
    replay: Optional[list[int]] = None,
    ngram_n: int = 4,
    table_bits: int = 16,
):
    """Greedy speculative decoding with the drafter on the device
    (``Runtime._spec_loop``): ``rounds_per_call`` rounds a call. Drafting
    is the device ngram hash table, or a replay oracle when ``replay`` (a
    known greedy continuation, its first token included) is given.

    Returns (prompt_ids, generated_ids, SpecStats) like generate_speculative.
    """
    ids = target._ids(prompt)
    stats = SpecStats()
    eos = target.eos_id
    w = 1 + n_draft
    chunk_adv = rounds_per_call * w
    kv = target.new_cache(1, capacity + chunk_adv + PREFILL_BUCKETS[0])
    logits, kv, n_past = target.eval_tokens(ids, kv, 0)
    cur = int(torch.argmax(logits[-1]))
    out = [cur]
    kind = "replay" if replay is not None else "ngram"
    loop = target._spec_loop(w, rounds_per_call, draft=kind, ngram_n=ngram_n,
                             table_bits=table_bits)
    dev = target.device
    if kind == "replay":
        # replay[0] is the first generated token (== cur); the tail is padded
        # so that slices past the end propose -1 (always rejected)
        pad = np.full((len(replay) + chunk_adv + w,), -1, np.int32)
        pad[:len(replay)] = replay
        rbuf = torch.from_numpy(pad).to(dev)
        pos = 1
    else:
        seq = ids + [cur]
        table = torch.from_numpy(_ngram_mod_prefeed(seq, n=ngram_n,
                                                    table_bits=table_bits)).to(dev)
        win = np.zeros((ngram_n,), np.int64)
        tailn = min(ngram_n, len(seq))
        win[ngram_n - tailn:] = seq[-tailn:]
        win = torch.from_numpy(win).to(dev)

    while (len(out) < max_new_tokens
           and n_past + chunk_adv <= kv.capacity
           and not (stop_at_eos and eos in out)):
        need = max_new_tokens - len(out)
        if kind == "replay":
            buf, cs, pos, cur, kv, n_past = loop(rbuf, pos, cur, kv, n_past)
        else:
            buf, cs, table, win, cur, kv, n_past = loop(table, win, cur, kv, n_past)
        cs = cs.tolist()
        out.extend(buf[:sum(cs)].tolist())
        # only the rounds up to the caller's budget count: rounds past it
        # still emit valid greedy tokens (cut below), but with a replay
        # buffer they run on exhausted (-1) proposals
        got = 0
        for c in cs:
            stats.n_rounds += 1
            stats.n_draft += n_draft
            stats.n_accept += c - 1
            got += c
            if got >= need:
                break

    out = out[:max_new_tokens]
    if stop_at_eos and eos in out:
        out = out[:out.index(eos) + 1]
    return ids, out, stats


def autotune_n_draft(target: Runtime, prompt, *, candidates=(4, 8, 16),
                     n_tokens: int = 32, draft: Optional[Runtime] = None,
                     seed: int = 0):
    """--spec-autotune analogue (common/spec-tuner.cpp): time each n_draft
    on a short probe generation and return (best_n, {n: tok_per_s})."""
    results = {}
    for n in candidates:
        t0 = time.perf_counter()
        _, out, _ = generate_speculative(target, prompt, n_tokens, draft=draft,
                                         n_draft=n, seed=seed, stop_at_eos=False)
        results[n] = len(out) / (time.perf_counter() - t0)
    best = max(results, key=results.get)
    return best, results


def generate_speculative(
    target: Runtime,
    prompt,
    max_new_tokens: int = 64,
    *,
    draft: Optional[Runtime] = None,
    n_draft: int = 8,
    sampler: SamplerParams | None = None,
    seed: int = 0,
    capacity: int = 1024,
    stop_at_eos: bool = True,
    stage="ngram",      # a stage name, "mtp", or a drafter instance
):
    """Returns (prompt_ids, generated_ids, SpecStats)."""
    sampler = sampler or SamplerParams(temp=0.0)
    ids = target._ids(prompt)
    stats = SpecStats()
    rng = np.random.default_rng(seed)
    if stage == "mtp":
        return _generate_mtp(target, ids, max_new_tokens, n_draft=n_draft,
                             sampler=sampler, rng=rng, capacity=capacity,
                             stop_at_eos=stop_at_eos, stats=stats)
    if _greedy_sampler(sampler) and not target.recurrent:
        # the greedy path: one verify forward a round, W ints read back
        return _generate_spec_greedy(
            target, ids, max_new_tokens, drafter=_drafter(stage), n_draft=n_draft,
            capacity=capacity, stop_at_eos=stop_at_eos, stats=stats, draft=draft)
    out, _, _ = _generate_spec_host(target, ids, max_new_tokens, draft=draft,
                                    n_draft=n_draft, sampler=sampler, rng=rng,
                                    capacity=capacity, stop_at_eos=stop_at_eos,
                                    stats=stats, drafter=_drafter(stage))
    return ids, out, stats


def _generate_spec_host(target: Runtime, ids, max_new_tokens, *, draft, n_draft,
                        sampler, rng, capacity, stop_at_eos, stats, drafter):
    """The sampling speculative loop (any sampler; every recurrent model):
    each verify reads back the logits of every position and samples them
    on the host. Returns (generated ids, the target's cache, its n_past)."""
    eos = target.eos_id
    kv = target.new_cache(1, capacity)
    logits, kv, n_past = target.eval_tokens(ids, kv, 0)
    d_kv = d_n_past = None
    if draft is not None:
        d_kv = draft.new_cache(1, capacity)
        _, d_kv, d_n_past = draft.eval_tokens(ids, d_kv, 0)

    out: list[int] = []

    def next_token(lg):
        return int(sample_token(lg, sampler, rng, history=ids + out))

    cur = next_token(logits[-1].cpu().numpy())
    out.append(cur)

    while len(out) < max_new_tokens:
        if stop_at_eos and cur == eos:
            break
        # ---- propose
        if draft is not None:
            proposal = []
            dl, d_kv, d_n_past = draft.eval_tokens([cur], d_kv, d_n_past)
            for _ in range(n_draft):
                t = int(torch.argmax(dl[-1]))
                proposal.append(t)
                dl, d_kv, d_n_past = draft.eval_tokens([t], d_kv, d_n_past)
        else:
            proposal = drafter.propose(ids + out, n_draft)
        stats.n_rounds += 1
        stats.n_draft += len(proposal)

        # ---- verify [cur] + proposal in one chunk
        block = [cur] + proposal
        # a recurrent state cannot be cut back by n_past: keep a copy of the
        # conv tails and recurrent states, restored on partial acceptance
        ckpt, np_ckpt = (kv.checkpoint(), n_past) if target.recurrent else (None, None)
        logits_all, kv, n_past = target.eval_tokens(block, kv, n_past, all_logits=True)
        logits_all = logits_all.cpu().numpy()
        # position j of logits_all predicts block[j+1]
        n_acc = 0
        for j, prop in enumerate(proposal):
            pred = next_token(logits_all[j])
            if pred != prop or len(out) >= max_new_tokens:
                out.append(pred)
                cur = pred
                break
            out.append(prop)
            n_acc += 1
            cur = prop
            if stop_at_eos and prop == eos:
                break
        else:
            # all accepted: sample one more from the last position
            pred = next_token(logits_all[len(proposal)])
            out.append(pred)
            cur = pred
        stats.n_accept += n_acc
        if hasattr(drafter, "accept"):
            drafter.accept(n_acc)       # acceptance feedback (ngram_mod's reset)

        # keep n_past at the position after the last accepted token
        consumed = 1 + n_acc
        if target.recurrent and consumed != len(block):
            # rebuild the state from the checkpoint over the accepted prefix
            kv.restore(ckpt)
            _, kv, n_past = target.eval_tokens(block[:consumed], kv, np_ckpt)
        else:
            n_past = n_past - (len(block) - consumed)
        if draft is not None:
            d_n_past = d_n_past - (len(proposal) - n_acc)

    return out[:max_new_tokens], kv, n_past


def _generate_mtp(target: Runtime, ids, max_new_tokens, *, n_draft, sampler, rng,
                  capacity, stop_at_eos, stats):
    """NextN/MTP self-speculation — the reference's MTP stage
    (common/speculative.cpp mtp_speculative_gen_draft / mtp_update_kv_cache):
    the trailing nextn layer drafts from the MAIN model's pre-output-norm
    hidden states; drafts are verified in the main model; the accepted rows
    of the MTP cache are refreshed with the main hidden states.

    Row convention: MTP row p holds (main hidden h_p, token t_{p+1}) and
    predicts t_{p+2}. A draft step runs at T = 1 (the decode attention
    kernel); the JAX package pads it to PREFILL_BUCKETS[0] rows with one
    real token, and nothing reads the padded rows."""
    if not target.has_mtp:
        raise ValueError("model has no nextn/MTP layer")
    from ..models.llama import mtp_forward
    out: list[int] = []
    dev = target.device

    def next_token(lg):
        return int(sample_token(lg.cpu().numpy(), sampler, rng, history=ids + out))

    kv = target.new_cache(1, capacity)
    logits_all, hid_all, kv, n_past = target.eval_tokens_hidden(ids, kv, 0)
    mtp_kv = target.new_mtp_cache(1, capacity)
    # warm-up rows 0..n-2: (h_p, t_{p+1})
    _, _, mtp_kv, mtp_n_past = target.mtp_eval(ids[1:], hid_all[:-1], mtp_kv, 0)
    last_hidden = hid_all[-1]
    cur = next_token(logits_all[-1])
    out.append(cur)

    while len(out) < max_new_tokens:
        if stop_at_eos and cur == target.eos_id:
            break
        # ---- draft: chain the MTP layer on its own output stream
        proposal = []
        tok_j, hid_j = cur, last_hidden
        mtp_pos = mtp_n_past
        for _ in range(n_draft):
            lg, mtp_kv, h_m = mtp_forward(
                target.params, target.cfg,
                torch.tensor([[tok_j]], dtype=torch.int64, device=dev),
                hid_j.reshape(1, 1, -1), mtp_kv, mtp_pos)
            tok_j = int(torch.argmax(lg[0, 0]))
            hid_j = h_m[0, 0]
            proposal.append(tok_j)
            mtp_pos += 1
        stats.n_rounds += 1
        stats.n_draft += len(proposal)

        # ---- verify in the main model
        block = [cur] + proposal
        p0 = n_past
        logits_blk, hid_blk, kv, n_past = target.eval_tokens_hidden(block, kv, n_past)
        logits_blk = logits_blk.cpu()
        n_acc = 0
        for j, prop in enumerate(proposal):
            pred = next_token(logits_blk[j])
            if pred != prop or len(out) >= max_new_tokens:
                out.append(pred)
                cur = pred
                break
            out.append(prop)
            n_acc += 1
            cur = prop
            if stop_at_eos and prop == target.eos_id:
                break
        else:
            pred = next_token(logits_blk[len(proposal)])
            out.append(pred)
            cur = pred
        stats.n_accept += n_acc

        consumed = 1 + n_acc
        n_past = p0 + consumed
        # ---- refresh MTP rows p0-1 .. p0+consumed-2 with the MAIN hiddens
        upd_hidden = torch.cat([last_hidden[None], hid_blk[:consumed - 1]])
        _, _, mtp_kv, mtp_n_past = target.mtp_eval(block[:consumed], upd_hidden,
                                                   mtp_kv, p0 - 1)
        last_hidden = hid_blk[consumed - 1]

    return ids, out[:max_new_tokens], stats
