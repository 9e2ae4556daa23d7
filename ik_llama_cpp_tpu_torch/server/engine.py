"""Continuous-batching slot engine — the analogue of the reference server's
update_slots loop (examples/server/server-context.cpp:4859).

The torch port of the JAX package's ``server/engine.py``. A fixed array of
slots shares one KV cache of ``n_slots`` rows. New prompts are prefilled
chunk by chunk into their slot's row; then every generating slot advances
together in one decode step over all rows, each row at its own position.
Sampling, stop strings and streaming run on the host, per slot.

The forward writes K/V rows into the cache in place. A prefill round runs
on a view of a span of adjacent rows (``narrow`` on the batch axis), so
its writes land in the shared cache with no copy. A row in the span, or in
the decode step, that has no token of its own writes junk where nothing
is read: past an idle slot's cached tokens, or at a busy slot's next
position, which its own next forward overwrites.

A recurrent model (the delta-net family's ``HybridCache``, the mamba
family's ``MambaCache``) runs every forward with ``n_valid``: 0 for a row
with no token of its own, so an idle or mid-prefill slot's conv tail and
recurrent state stay exactly as they were. A cache with no KV rows
reports a capacity of 2^30, so only the engine's own ``capacity`` (its
context size) bounds a slot and triggers its context shift. Its state has seen every cached token and cannot be cut back, so a
slot's state is reused only when the new prompt strictly extends the
slot's cached tokens; otherwise, and on a context shift's re-prefill, the
slot's recurrent rows are zeroed and the prompt is prefilled from 0. The
RAM prompt-cache tier is refused for such a model.

Ring caches (``--swa-compress``, a ``SwaKVCache``) keep position p of a
sliding-window layer in ring slot p % ring. Every forward passes
``n_valid``, so padded and idle rows write nothing to the rings. A slot
reuses a cached prefix only where its rings still hold the window before
it (``_ring_reusable``), else it prefills from 0; its context shift
re-prefills; the RAM tier parks no ring rows and slot save / restore
refuses them.

Speculative drafting (``spec``: ngram, suffix, ngram-mod, ngram-cache,
eagle3) gives each generating slot a host drafter; when any slot has a
draft, the step verifies [last token | draft] of every row in one forward
of width 1 + spec_n, each row at its own position, and emits tokens while
they match the draft. A drafter serves one request: it is dropped when the
request ends or the slot's context shifts, since its state indexes the
slot's token list (the JAX engine keeps it, and a shorter list later makes
SuffixDraft index past its end). Rejected K/V rows stay where they are:
n_past does not advance past them, and the next forward overwrites them. A recurrent
model keeps a copy of its conv tails and recurrent states before the
verify and replays each partially accepting row's accepted prefix from it.

An exception in the engine thread fails the requests it was serving: each
carries the error text (``Request.error``) and ``n_failed`` counts them;
the engine keeps serving.

An encoder-only model (the BERT family, on a ``NoCache``) starts an
engine that refuses every generation request; the server's embeddings
routes serve it.

The request options run as in the JAX engine, on the host: the
unicode-script allowlist (``runtime/allowlist.py``) and expiring logit
biases (``runtime/expiring_bias.py``) add to a row's logits; grammar kinds
other than GBNF compile through ``runtime/llg.py``; a lazy grammar waits
for its trigger word; banned strings and regexes rewind the slot to the
token where the match starts and ban it there (``_check_bans``: the
rewound rows are overwritten by the next forwards, and at the end the
slot keeps ``cache_tokens = tokens[:n_past]``); the reasoning budget
forces its end tag; ``post_sampling_probs`` reports the sampler chain's
probabilities. Each of them that needs the whole row of logits turns the
top-k readback off for the step (``_slot_topk_ok``). A recurrent model
drops the bans, as the JAX engine does: its state cannot be rewound.

Slot save, restore and erase (``save_slot`` / ``restore_slot`` /
``erase_slot``) run on the loop thread, between two steps, as queued
commands: the forwards write the cache in place. A restore takes an idle
slot only. The state file is ``runtime/state.py``'s.

DFlash drafting and tensor/pipeline parallel serving are later slices:
asking for one raises NotImplementedError.
"""
from __future__ import annotations

import logging
import queue
import re
import threading
import time
import traceback
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

import numpy as np
import torch

from ..models import llama as llama_mod
from ..models.llama import KVCache, MixedKVCache, SwaKVCache
from ..runtime.generate import FORWARDS, PREFILL_BUCKETS, Runtime, _bucket, _chunk_limit
from ..runtime.speculative import DRAFTERS
from ..runtime.sampling import (SamplerParams, SamplerState,
                                sample as sample_token, sample_topk,
                                topk_chain_compatible)

TOPK_FETCH = 128   # top-k readback width (>= top_k + the penalty window)


class SlotState(Enum):
    IDLE = 0
    QUEUED = 1
    PREFILL = 2
    GENERATING = 3


@dataclass
class Request:
    prompt_ids: list[int]
    n_predict: int = 128
    sampler: SamplerParams = field(default_factory=lambda: SamplerParams(temp=0.8))
    seed: int = 0
    stop: list[str] = field(default_factory=list)
    grammar: str | None = None         # grammar text (constrained decoding)
    # the grammar's dialect: gbnf, or regex / json / lark through
    # runtime/llg.py (a backend registered there under the kind's name
    # takes it instead)
    grammar_kind: str = "gbnf"
    # lazy grammar: dormant until a trigger word appears in the generated
    # text, then enforced from the trigger on
    grammar_lazy: bool = False
    grammar_triggers: list = field(default_factory=list)
    stream_queue: Optional[queue.Queue] = None  # receives (token_id, text, done)
    id: int = 0
    cancelled: bool = False       # client disconnect -> slot release
    # tokens inside <think>...</think> before a forced close (-1 = no limit)
    reasoning_budget: int = -1
    # n_probs > 0: per emitted token append {"id", "logprob", "top":
    # [(id, logprob) x n_probs]} to probs_out
    n_probs: int = 0
    post_sampling_probs: bool = False   # probs of the chain's candidates
    probs_out: list = field(default_factory=list)
    # context-shift tuning (-1 = engine defaults)
    n_keep: int = -1
    n_discard: int = -1
    cache_prompt: bool = True     # false disables prefix reuse
    # banned phrases (server-context.cpp:4508 rewind_context): a match in
    # the held-back text rewinds the slot to the token where it starts,
    # biases that token there by banned_bias, and samples again
    banned_strings: list = field(default_factory=list)   # lowercased
    banned_regex: list = field(default_factory=list)
    banned_regex_ci: list = field(default_factory=list)
    banned_bias: float = -999.0
    banned_n: int = 1
    banbuffer: int = 0            # chars held from the stream (0 = auto)
    rewind_count_max: int = -1    # -1 heuristic, 0 unlimited, >0 strict
    saturate_predict: bool = False   # rewound tokens refund n_predict
    reasoning_start_tag: str = "<think>"
    reasoning_end_tag: str = "</think>"
    reasoning_message: str = "\n"
    # unicode-script allowlist: rulesets of (lower_cpt, upper_cpt, script,
    # bias) tuples; keywords in the generated text expire them in order
    allow_rules: list = field(default_factory=list)
    allow_pieces: list = field(default_factory=list)
    allow_kws: list = field(default_factory=list)
    allow_kw_delay: int = 0
    # expiring logit bias rule text (a string or a list of lines)
    expiring_logit_bias: Any = None
    # set when the engine failed this request: the error's text
    error: str | None = None


@dataclass
class Slot:
    idx: int
    state: SlotState = SlotState.IDLE
    req: Optional[Request] = None
    tokens: list[int] = field(default_factory=list)   # prompt + generated
    cache_tokens: list[int] = field(default_factory=list)  # tokens with KV rows
    weights_epoch: int = 0        # the engine's weights_epoch its rows were made at
    n_prompt: int = 0
    n_past: int = 0
    n_decoded: int = 0
    n_shifts: int = 0
    rng: Any = None
    sampler_state: Any = None
    text: str = ""
    n_streamed: int = 0         # chars of .text already sent to the stream
    pending: bytes = b""        # partial UTF-8 tail awaiting continuation
    grammar: Any = None         # per-request GrammarSampler (stateful)
    forced: list = field(default_factory=list)   # forced next tokens
    n_think: int = 0
    gen_pieces: list = field(default_factory=list)  # text piece a generated token
    pos_bans: dict = field(default_factory=dict)    # token index -> {ids}
    rewind_count: int = 0
    allowlist: Any = None       # runtime.allowlist.AllowlistState | None
    elb: Any = None             # runtime.expiring_bias.ElbRuntime | None
    lazy_grammar: Any = None    # (gbnf text, [trigger words]) while dormant
    t_start: float = 0.0
    t_first_token: float = 0.0
    drafter: Any = None         # the slot's self-speculation drafter (spec)


def _partial_stop_holdback(text: str, stops) -> int:
    """Length of the longest suffix of ``text`` that is a proper prefix of
    any stop string (the reference's find_partial_stop_string) — that many
    chars must be withheld from the stream until disambiguated."""
    hb = 0
    for s in stops:
        if not s:
            continue
        for ln in range(min(len(s) - 1, len(text)), hb, -1):
            if text.endswith(s[:ln]):
                hb = ln
                break
    return hb


class HostPromptCache:
    """RAM tier of evicted slot KV states — the ``--cache-ram`` (-cram)
    analogue (server_prompt_cache, reference server-task.h:431,
    server-task.cpp:1084 similarity-matched load). Evicted/replaced slot
    rows are parked in host RAM; at slot admission the store is searched
    for the entry with the longest reusable prefix of the new prompt.
    Bounded by MiB and/or tokens with oldest-first eviction."""

    def __init__(self, limit_mib: int = 2048, limit_tokens: int = 0,
                 min_reusable_fraction: float = 0.1):
        self.limit_bytes = 0 if limit_mib < 0 else limit_mib * (1 << 20)
        self.limit_tokens = limit_tokens
        self.min_frac = min_reusable_fraction
        self.entries: list[dict] = []           # oldest first
        self.n_hits = 0
        self.n_saves = 0

    @property
    def size_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries)

    @property
    def n_tokens(self) -> int:
        return sum(len(e["tokens"]) for e in self.entries)

    def save(self, tokens: list[int], arrays: dict) -> None:
        """Park a slot state (host arrays, trimmed to len(tokens))."""
        if not tokens:
            return
        nbytes = sum(a.nbytes for a in arrays.values() if a is not None)
        self.entries.append({"tokens": list(tokens), "arrays": arrays,
                             "bytes": nbytes})
        self.n_saves += 1
        self.update()

    def best_match(self, new_tokens: list[int], beat: int = 0):
        """Entry with the longest common prefix vs ``new_tokens`` that (a)
        reuses at least min_frac of the cached prompt (reference f_keep
        test) and (b) beats ``beat`` (the slot's own local prefix).
        Returns (entry, lcp) or (None, 0); a hit REMOVES the entry."""
        best, best_lcp = None, beat
        for e in self.entries:
            lcp = 0
            for a, b in zip(e["tokens"], new_tokens):
                if a != b:
                    break
                lcp += 1
            if lcp <= best_lcp:
                continue
            if lcp / max(1, len(e["tokens"])) < self.min_frac:
                continue
            best, best_lcp = e, lcp
        if best is None:
            return None, 0
        self.entries.remove(best)
        self.n_hits += 1
        return best, best_lcp

    def update(self) -> None:
        """Evict oldest entries until within the size/token limits."""
        while self.entries and (
                (self.limit_bytes and self.size_bytes > self.limit_bytes)
                or (self.limit_tokens and self.n_tokens > self.limit_tokens)):
            self.entries.pop(0)


# ------------------------------------------------------------ cache rows
_MIXED_FIELDS = ("k_ovr", "v_ovr", "ks_ovr", "vs_ovr",
                 "k_mid", "v_mid", "ks_mid", "vs_mid")


_KV_FIELDS = ("k", "v", "k_scale", "v_scale")


def _cache_tensors(kv) -> list:
    """The cache's tensors, each with the batch on axis 1: a recurrent
    cache's ``ROW_FIELDS`` (``HybridCache``, ``MambaCache``), or the KV
    fields (a field that is None, as the latent cache's v of a model
    without an indexer, is left out)."""
    if isinstance(kv, MixedKVCache):
        return [getattr(kv, f) for f in _MIXED_FIELDS]
    if isinstance(kv, SwaKVCache):
        return [kv.k_full, kv.v_full, kv.k_swa, kv.v_swa]
    fields = getattr(kv, "ROW_FIELDS", None)
    if fields is not None:
        return [getattr(kv, f) for f in fields]
    return [t for t in (getattr(kv, f) for f in _KV_FIELDS) if t is not None]


def _like(kv, tensors: list):
    """A cache of kv's type over ``tensors`` (in _cache_tensors order)."""
    if isinstance(kv, MixedKVCache):
        return MixedKVCache(*tensors, layer_map=kv.layer_map)
    if isinstance(kv, SwaKVCache):
        return SwaKVCache(*tensors, layer_map=kv.layer_map)
    if getattr(kv, "ROW_FIELDS", None) is not None:
        return type(kv)(*tensors)
    it = iter(tensors)
    return KVCache(**{f: None if getattr(kv, f) is None else next(it) for f in _KV_FIELDS})


def cache_rows(kv, start: int, n: int = 1):
    """Rows [start, start + n) of a shared cache as a cache of the same type
    whose tensors are views: writes through it land in ``kv``. Each layer's
    slab of a view is contiguous, as the attention kernels need."""
    return _like(kv, [t.narrow(1, start, n) for t in _cache_tensors(kv)])


def topk_readback(last_logits: torch.Tensor, k: int):
    """The top-k of each row's logits (values descending, ids) and the row's
    log-sum-exp over the whole vocabulary, read back to the host: B x (K+1)
    floats a step instead of B x V. ``last_logits`` (B, V)."""
    row = last_logits.float()
    vals, idx = torch.topk(row, k, dim=-1)
    lse = torch.logsumexp(row, dim=-1)
    return vals.cpu().numpy(), idx.cpu().numpy(), lse.cpu().numpy()


class BatchEngine:
    """Owns the model and the shared KV cache; runs the slot loop in a
    thread."""

    def __init__(self, runtime: Runtime, n_slots: int = 4, capacity: int = 2048,
                 spec: str | None = None, spec_n: int = 8,
                 cache_ram_mib: int = 0):
        if spec and spec.startswith("dflash:"):
            llama_mod._later("DFlash drafting (the dflash draft model)",
                             "other architectures (item 8)")
        if spec and spec not in DRAFTERS:
            raise ValueError(f"unknown speculative stage {spec!r}: one of {sorted(DRAFTERS)}")
        self.spec = spec or None
        self.spec_n = spec_n
        self.rt = runtime
        self.cfg = runtime.cfg
        self.device = runtime.device
        if self.device.type == "cuda" and self.device.index is None:
            # the loop thread gets the card by its index, fixed here
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_slots = n_slots
        self.capacity = capacity
        self.kv = runtime.new_cache(n_slots, capacity)
        if cache_ram_mib != 0 and runtime.recurrent:
            # a partial prefix match cannot restore a recurrent state
            llama_mod._later("the RAM prompt-cache tier for a recurrent model",
                             "server extras (item 7)")
        # RAM prompt-cache tier (0 = disabled, -1 = unlimited, else MiB)
        self.prompt_cache = (HostPromptCache(cache_ram_mib)
                             if cache_ram_mib != 0 else None)
        self.slots = [Slot(i) for i in range(n_slots)]
        self._allow_cache: dict = {}   # the allowlist's vocab flattening, shared
        self.requests: queue.Queue[Request] = queue.Queue()
        # slot save / restore / erase, run on the loop thread between steps
        self._commands: queue.Queue = queue.Queue()
        self._bans_dropped = False     # logged once on a recurrent model
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._submit_lock = threading.Lock()     # submit() runs on many threads
        # bumped when the weights change under the cache (an adapter's
        # scale): rows made before are not reused
        self.weights_epoch = 0
        # metrics
        self.n_prompt_tokens_processed = 0
        self.n_prompt_tokens_cached = 0
        self.n_tokens_predicted = 0
        self.n_rewinds = 0
        self.n_topk_steps = 0
        self.n_decode_steps = 0
        self.n_prefill_forwards = 0
        self.n_requests = 0
        self.n_failed = 0
        self.n_draft_proposed = 0
        self.n_draft_accepted = 0
        self.n_spec_steps = 0

    # ---------------------------------------------------------------- loop
    def start(self):
        self._thread = threading.Thread(target=self.run_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, req: Request):
        if self.rt.encoder_only:
            raise NotImplementedError(
                f"{self.cfg.arch} is an encoder with no LM head: it generates no text "
                "(its embeddings are served by /embedding and /v1/embeddings)")
        with self._submit_lock:
            self.n_requests += 1
        self.requests.put(req)

    def _forward(self, toks: np.ndarray, kv, n_past, n_valid: list) -> torch.Tensor:
        """One forward over rows of the shared cache; ``n_valid`` (a length
        a row, 0 for a row with no token of its own) reaches the forward
        when the runtime needs it: a recurrent model's, which keeps the
        padded rows out of its state, and a llama model's on ring caches
        (--swa-compress), which drops the padded and idle rows' ring writes."""
        kw = {"n_valid": n_valid} if self.rt.needs_n_valid else {}
        return FORWARDS[self.cfg.arch](self.rt.params, self.cfg,
                                       torch.from_numpy(toks).to(self.device), kv, n_past,
                                       **kw)

    def _slot_state_to_host(self, slot) -> dict | None:
        """One slot's filled KV rows on the host (RAM-cache save)."""
        n = len(slot.cache_tokens)
        if n == 0 or isinstance(self.kv, SwaKVCache):
            return None          # a ring's rows are not positions: not parked, as in JAX
        return {str(i): t[:, slot.idx, :n].to("cpu", copy=True)
                for i, t in enumerate(_cache_tensors(self.kv))}

    def _restore_slot_state(self, slot, entry) -> None:
        a = entry["arrays"]
        n = min(len(entry["tokens"]), self.capacity - 1)
        for i, t in enumerate(_cache_tensors(self.kv)):
            t[:, slot.idx, :n] = a[str(i)][:, :n].to(t.device)
        slot.cache_tokens = entry["tokens"][:n]

    def _admit(self):
        for slot in self.slots:
            if slot.state != SlotState.IDLE:
                continue
            try:
                req = self.requests.get_nowait()
            except queue.Empty:
                return
            slot.req = req
            # the prompt's tail, leaving room for n_predict tokens; at least
            # half the context when n_predict alone would fill it
            keep = max(self.capacity // 2, self.capacity - req.n_predict - 1)
            slot.tokens = list(req.prompt_ids)[-keep:]
            slot.n_prompt = len(slot.tokens)
            if not slot.tokens:
                self._fail(slot, "ValueError: empty prompt")
                continue
            if slot.weights_epoch != self.weights_epoch:
                # rows made under other weights (the reference server clears
                # a slot's cached tokens when its LoRA set changes)
                slot.cache_tokens = []
                slot.weights_epoch = self.weights_epoch
            # prompt-cache reuse: skip the common prefix with the slot's
            # previous contents — at least one token is evaluated again
            prefix = 0
            if req.cache_prompt:
                for a, b in zip(slot.cache_tokens, slot.tokens):
                    if a != b:
                        break
                    prefix += 1
            if self.prompt_cache is not None and req.cache_prompt:
                # RAM tier: a parked state with a longer reusable prefix than
                # the slot's own rows; park the current occupant before its
                # rows are overwritten
                entry, lcp = self.prompt_cache.best_match(slot.tokens,
                                                          beat=prefix)
                diverges = prefix < len(slot.cache_tokens)
                if entry is not None or diverges:
                    state = self._slot_state_to_host(slot)
                    if state is not None:
                        self.prompt_cache.save(slot.cache_tokens, state)
                if entry is not None:
                    self._restore_slot_state(slot, entry)
                    prefix = lcp
            if prefix and isinstance(self.kv, SwaKVCache) and not self._ring_reusable(slot, prefix):
                prefix = 0           # the ring no longer holds the prefix's window
            if self.rt.recurrent and not 0 < prefix == len(slot.cache_tokens) < slot.n_prompt:
                # the state has seen every cached token: reused only when the
                # prompt strictly extends them, else the slot starts afresh
                prefix = 0
                slot.cache_tokens = []
                self.kv.zero_row(slot.idx)
            slot.n_past = min(prefix, slot.n_prompt - 1)
            self.n_prompt_tokens_cached += slot.n_past
            slot.n_decoded = 0
            slot.n_shifts = 0
            slot.text = ""
            slot.n_streamed = 0
            slot.pending = b""
            slot.rng = np.random.default_rng(req.seed)
            slot.sampler_state = SamplerState()
            slot.forced = []
            slot.n_think = 0
            try:
                self._admit_options(slot, req)
            except Exception as e:          # noqa: BLE001 - fails this request only
                traceback.print_exc()
                self._fail(slot, f"{type(e).__name__}: {e}")
                continue
            slot.state = SlotState.PREFILL
            slot.t_start = time.time()
            slot.t_first_token = 0.0

    def _ring_reusable(self, slot: Slot, prefix: int) -> bool:
        """Whether a slot's ring layers still hold the rows of the window
        before ``prefix``. Position x lives in ring slot x % ring until a
        later position overwrites it; the slot has written positions below
        ``len(cache_tokens)`` plus a speculative verify block at most. The
        next token at ``prefix`` attends x in [prefix - window, prefix), so
        the prefix is reused only when the last write, minus the ring,
        lies below all of them; else the slot prefills from 0, which
        rewrites every position it attends."""
        hi = len(slot.cache_tokens) + (self.spec_n + 1 if self.spec else 1)
        return hi - self.kv.swa_cap <= max(0, prefix - self.cfg.swa_window)

    def _admit_options(self, slot: Slot, req: Request) -> None:
        """The request options' per-slot state: the grammar (of any kind,
        lazy or not), the allowlist, the expiring biases, the ban buffer."""
        slot.grammar = None
        slot.lazy_grammar = None
        g_text = req.grammar
        if g_text and req.grammar_kind not in ("gbnf", "grammar"):
            from ..runtime import llg
            if req.grammar_kind in llg._BACKENDS:
                # a registered engine: its stateful sampler object
                slot.grammar = llg.constraint_from(req.grammar_kind, g_text,
                                                   self.rt.tokenizer, backend=req.grammar_kind)
                g_text = None
            else:
                g_text = llg.to_gbnf(req.grammar_kind, g_text)
        if g_text and req.grammar_lazy and req.grammar_triggers:
            slot.lazy_grammar = (g_text, [str(t) for t in req.grammar_triggers])
        elif g_text:
            from ..runtime.grammar import Grammar, GrammarSampler
            slot.grammar = GrammarSampler(Grammar(g_text), self.rt.tokenizer)
        slot.gen_pieces = []
        slot.pos_bans = {}
        slot.rewind_count = 0
        slot.allowlist = None
        if req.allow_rules:
            from ..runtime.allowlist import build_allowlist
            slot.allowlist = build_allowlist(
                self.rt.tokenizer, req.allow_rules, req.allow_kws,
                pieces=req.allow_pieces, kw_delay=req.allow_kw_delay,
                vocab_cache=self._allow_cache)
        slot.elb = None
        if req.expiring_logit_bias is not None:
            from ..runtime.expiring_bias import build_elb_runtime
            slot.elb = build_elb_runtime(self.rt.tokenizer, req.expiring_logit_bias,
                                         req.sampler)
        bans = req.banned_strings or req.banned_regex or req.banned_regex_ci
        if self.rt.recurrent and bans:
            # a recurrent state cannot be rewound: the bans go, as in JAX
            if not self._bans_dropped:
                logging.getLogger("ik_llama_cpp_tpu_torch").warning(
                    "banned strings and regexes are dropped on %s: its recurrent "
                    "state cannot be rewound", self.cfg.arch)
                self._bans_dropped = True
            req.banned_strings, req.banned_regex, req.banned_regex_ci = [], [], []
            req.banbuffer = 0
        if req.banned_strings and req.banbuffer <= 0:
            # the longest phrase + 1 chars (the reference's n_buffer)
            req.banbuffer = max(len(b) for b in req.banned_strings) + 1
        if (req.banned_regex or req.banned_regex_ci) and req.banbuffer <= 0:
            req.banbuffer = 64

    def _room(self, s: Slot, n: int) -> bool:
        """Whether row ``s`` can take an n-token write in a prefill forward:
        a busy slot at its next position, an idle one anywhere (_junk_row)."""
        return s.state == SlotState.IDLE or s.n_past + n <= self.kv.capacity

    def _junk_row(self, s: Slot, n: int) -> int:
        """Where a row with no token of its own in a forward writes its n
        junk rows: past an idle slot's cached tokens, whose tail gives way
        at the cache's end; at a busy slot's next position, which its own
        next forward overwrites before anything reads it."""
        if s.state != SlotState.IDLE:
            return s.n_past
        at = min(len(s.cache_tokens), self.kv.capacity - n)
        if self.rt.recurrent and at < len(s.cache_tokens):
            s.cache_tokens = []       # a recurrent state cannot be cut back
        del s.cache_tokens[at:]
        return at

    def _spans(self, slots: list, chunks: dict) -> list:
        """The prefilling slots in spans of adjacent rows, each one forward
        at one bucket: a span takes the next slot when every row from its
        first to that slot, the rows between included, has room for the
        bucket."""
        spans = []
        for s in sorted(slots, key=lambda s: s.idx):
            if spans:
                span = spans[-1] + [s]
                b = max(_bucket(len(chunks[m.idx])) for m in span)
                if all(self._room(r, b) for r in self.slots[span[0].idx:s.idx + 1]):
                    spans[-1] = span
                    continue
            spans.append([s])
        return spans

    def _do_prefill_batch(self, slots: list):
        """One chunk for each PREFILL slot, in one forward over each span of
        adjacent rows (the analogue of update_slots packing every prompt
        chunk into one llama_batch, server-context.cpp:4131-4206); a slot
        whose prompt ends emits its first token."""
        chunks = {}
        for s in slots:
            n = min(PREFILL_BUCKETS[-1], _chunk_limit(self.kv, s.n_past))
            chunks[s.idx] = s.tokens[s.n_past:s.n_prompt][:n]
        for span in self._spans(slots, chunks):
            lo, hi = span[0].idx, span[-1].idx + 1
            b = max(_bucket(len(chunks[s.idx])) for s in span)
            toks = np.zeros((hi - lo, b), np.int64)
            ids = {s.idx for s in span}
            n_past = [s.n_past if s.idx in ids else self._junk_row(s, b)
                      for s in self.slots[lo:hi]]
            n_valid = [len(chunks[s.idx]) if s.idx in ids else 0 for s in self.slots[lo:hi]]
            for s in span:
                toks[s.idx - lo, :len(chunks[s.idx])] = chunks[s.idx]
            logits = self._forward(toks, cache_rows(self.kv, lo, hi - lo), n_past, n_valid)
            self.n_prefill_forwards += 1
            rows = torch.tensor([s.idx - lo for s in span], device=logits.device)
            last = torch.tensor([len(chunks[s.idx]) - 1 for s in span],
                                device=logits.device)
            for s, lg in zip(span, logits[rows, last].cpu().numpy()):
                n = len(chunks[s.idx])
                s.n_past += n
                self.n_prompt_tokens_processed += n
                if s.n_past >= s.n_prompt:
                    s.state = SlotState.GENERATING
                    if s.t_first_token == 0.0:
                        s.t_first_token = time.time()
                    self._emit_token(s, lg)

    def _fail(self, slot: Slot, msg: str) -> None:
        """Fail the slot's request: it carries ``msg`` and ends its stream."""
        req = slot.req
        if req is not None:
            req.error = msg
            self.n_failed += 1
            if req.stream_queue is not None:
                req.stream_queue.put((-1, "", True))
        slot.req = None
        slot.state = SlotState.IDLE
        slot.cache_tokens = []      # its rows may be half written
        slot.drafter = None

    def _emit_token(self, slot: Slot, logits: np.ndarray | None, topk=None) -> bool:
        """Sample the slot's next token from its row of logits (or from
        the top-k readback), append it and stream its text. Returns True
        when a banned phrase rewound the slot instead: nothing was emitted,
        and ``n_past`` and ``tokens`` went back to the ban's position."""
        req = slot.req
        if topk is None and slot.allowlist is not None:
            # allowlist biases go on the raw logits before any sampler
            # stage (common/sampling.cpp:640 server_biases); -inf bans
            srv_bias = slot.allowlist.active_bias()
            if srv_bias is not None and len(srv_bias) == len(logits):
                logits = np.asarray(logits, np.float32) + srv_bias
        if topk is None and slot.elb is not None:
            # expiring biases: the state machine's token biases on the raw
            # logits and its sampler-parameter toggles (sampling.cpp:836)
            logits = np.asarray(logits, np.float32).copy()
            slot.elb.apply(logits, slot.text)
        bans = slot.pos_bans.get(len(slot.tokens))
        if bans and topk is None:
            # a rewind's bans at exactly this position (server-context.cpp:4773)
            logits = np.asarray(logits, np.float32).copy()
            for t in bans:
                logits[t] += req.banned_bias
        post = None
        if slot.forced:
            tok = slot.forced.pop(0)
        elif topk is not None:
            # top-k readback: only (vals, ids, lse) left the card;
            # _slot_topk_ok guaranteed exactness
            vals, tidx, lse = topk
            if bans:
                vals = vals.copy()
                for t in bans:
                    m = np.where(tidx == t)[0]
                    if len(m):
                        vals[m[0]] += req.banned_bias
            tok = sample_topk(vals, tidx, lse, req.sampler, slot.rng,
                              history=slot.tokens, state=slot.sampler_state)
        elif slot.grammar is not None:
            # constrained decoding: chain once, grammar-mask the surviving
            # candidates; the sampler's state advances with the accepted text
            try:
                tok = slot.grammar.filter_and_pick(
                    logits, req.sampler, slot.rng, history=slot.tokens,
                    state=slot.sampler_state)
            except RuntimeError as e:
                # the grammar dead-ends against the vocab: fail THIS request
                self._fail(slot, f"grammar: {e}")
                return False
        elif req.n_probs > 0 and req.post_sampling_probs:
            tok, p_order, p_probs = sample_token(
                logits, req.sampler, slot.rng, history=slot.tokens,
                state=slot.sampler_state, return_probs=True)
            post = (np.asarray(p_order), np.asarray(p_probs))
        else:
            tok = sample_token(logits, req.sampler, slot.rng,
                               history=slot.tokens, state=slot.sampler_state)
        slot.tokens.append(int(tok))
        slot.n_decoded += 1
        self.n_tokens_predicted += 1
        if req.n_probs > 0 and post is not None:
            # the probabilities of the chain's surviving candidates
            p_order, p_probs = post
            n = min(req.n_probs, len(p_order))
            where = np.where(p_order == int(tok))[0]
            own = float(np.log(p_probs[where[0]] + 1e-30)) if len(where) else 0.0
            req.probs_out.append({
                "id": int(tok), "logprob": own,
                "top": [(int(p_order[i]), float(np.log(p_probs[i] + 1e-30)))
                        for i in range(n)]})
        elif req.n_probs > 0:
            # log-softmax over the raw logits (pre-sampling probabilities,
            # the reference's default n_probs mode)
            lg = np.asarray(logits, np.float32).reshape(-1)
            lse = float(np.logaddexp.reduce(lg))
            n = min(req.n_probs, len(lg))
            top_ids = np.argpartition(-lg, n - 1)[:n]
            top_ids = top_ids[np.argsort(-lg[top_ids])]
            req.probs_out.append({
                "id": int(tok), "logprob": float(lg[int(tok)] - lse),
                "top": [(int(t), float(lg[t] - lse)) for t in top_ids]})
        # streaming-safe detok: buffer bytes until they form valid UTF-8
        raw = slot.pending + self.rt.tokenizer.decode_bytes([int(tok)])
        try:
            piece = raw.decode("utf-8")
            slot.pending = b""
        except UnicodeDecodeError as e:
            if e.reason.startswith("unexpected end") or e.start > 0 and \
                    len(raw) - e.start < 4:
                piece = raw[: e.start].decode("utf-8", errors="replace")
                slot.pending = raw[e.start:]
            else:
                piece = raw.decode("utf-8", errors="replace")
                slot.pending = b""
        done = False
        if tok == self.rt.tokenizer.eos_id:
            done = True
            piece = ""            # the eos token's own text is never emitted
        prev_len = len(slot.text)
        if slot.elb is not None:
            # count-up and exit/jump-word scan over the text BEFORE this
            # piece (sampling.cpp:941 accept)
            slot.elb.accept(slot.text, piece)
        slot.text += piece
        if slot.allowlist is not None:
            # keywords in the new text expire rulesets in order
            slot.allowlist.update(slot.text, prev_len, slot.n_decoded)
        slot.gen_pieces.append(piece)
        if req.cancelled:
            # before the rewind: a client that left is released even under
            # an unlimited rewind budget
            done = True
        if slot.lazy_grammar is not None and slot.grammar is None and piece:
            # a lazy grammar wakes at its first trigger word and takes the
            # text from the trigger on
            g_text, triggers = slot.lazy_grammar
            hits = [h for h in (slot.text.find(t) for t in triggers) if h >= 0]
            if hits:
                from ..runtime.grammar import Grammar, GrammarSampler
                gs = GrammarSampler(Grammar(g_text), self.rt.tokenizer)
                if gs.grammar.accept_text(slot.text[min(hits):]):
                    slot.grammar = gs
                slot.lazy_grammar = None
        if not done and slot.grammar is None and (
                req.banned_strings or req.banned_regex or req.banned_regex_ci):
            if self._check_bans(slot):
                return True       # rewound: nothing emitted this round
        if slot.n_decoded >= req.n_predict:
            done = True
        for stop_s in req.stop:
            if stop_s and stop_s in slot.text:
                slot.text = slot.text.split(stop_s)[0]
                done = True
        # the reasoning budget: force the <think> block closed when spent
        # (common/reasoning-budget.cpp)
        if req.reasoning_budget >= 0 and not slot.forced and not done:
            tail = slot.text.rsplit(req.reasoning_start_tag, 1)
            if len(tail) == 2 and req.reasoning_end_tag not in tail[1]:
                slot.n_think += 1
                if slot.n_think >= req.reasoning_budget:
                    slot.forced = self.rt.tokenizer.encode(
                        req.reasoning_message + req.reasoning_end_tag + "\n",
                        add_bos=False)
        if req.stream_queue is not None:
            # stream from the (possibly stop-trimmed) accumulated text, and
            # hold back any suffix that could be the start of a stop string
            # (find_partial_stop_string), and the ban buffer's rewindable
            # tail
            safe = len(slot.text)
            if not done:
                safe -= max(_partial_stop_holdback(slot.text, req.stop), req.banbuffer)
            out = slot.text[slot.n_streamed: safe] if safe > slot.n_streamed \
                else ""
            slot.n_streamed += len(out)
            req.stream_queue.put((int(tok), out, done))
        if done:
            # the last token has no KV row yet: the cache holds n_past rows
            slot.cache_tokens = slot.tokens[:slot.n_past]
            slot.state = SlotState.IDLE
            slot.req = None
            slot.drafter = None       # its state indexes this request's tokens
        return False

    def _check_bans(self, slot: Slot) -> bool:
        """Banned-phrase rewind (rewind_context, server-context.cpp:4508):
        search the held-back tail of the generated text for banned strings
        and regexes; on a match, ban the token(s) at the match's position
        and rewind the slot there to sample again. The rows past the new
        n_past are overwritten by the next forwards. Returns True when
        rewound."""
        req = slot.req
        W = req.banbuffer
        win = slot.text[-W:] if W > 0 else slot.text
        base = len(slot.text) - len(win)
        best = None
        low = win.lower()
        for ph in req.banned_strings:
            i = low.find(ph)
            if i >= 0 and (best is None or i < best):
                best = i
        for pats, flags in ((req.banned_regex, 0), (req.banned_regex_ci, re.IGNORECASE)):
            for pat in pats:
                try:
                    m = re.search(pat, win, flags)
                except re.error:
                    continue
                if m and (best is None or m.start() < best):
                    best = m.start()
        if best is None:
            return False
        # the rewind budget (the reference's heuristic / strict / unlimited)
        total = len(req.banned_strings) + len(req.banned_regex) + len(req.banned_regex_ci)
        if req.rewind_count_max == -1:
            if slot.rewind_count >= 20 and slot.rewind_count > 2 * total:
                return False
        elif req.rewind_count_max > 0 and slot.rewind_count >= req.rewind_count_max:
            return False
        # a backstop even when unlimited: with saturate_predict a pattern
        # matching everything would never end
        if slot.rewind_count >= 100 + 20 * max(1, req.n_predict):
            return False
        # the match's char offset -> its generated token g
        off = base + best
        cum = g = 0
        for g, piece in enumerate(slot.gen_pieces):
            if cum + len(piece) > off:
                break
            cum += len(piece)
        ban_idx = slot.n_prompt + g
        if req.stream_queue is not None and cum < slot.n_streamed:
            # the token began before the held-back window: its head reached
            # the client already, so it stands
            return False
        n = req.banned_n
        banned = (slot.tokens[ban_idx:ban_idx + n] if n > 0
                  else slot.tokens[ban_idx:] if n < 0 else [])
        if banned:
            slot.pos_bans.setdefault(ban_idx, set()).update(int(t) for t in banned)
        slot.rewind_count += 1
        self.n_rewinds += 1
        slot.tokens = slot.tokens[:ban_idx]
        slot.gen_pieces = slot.gen_pieces[:g]
        slot.text = slot.text[:cum]
        if req.saturate_predict:
            slot.n_decoded = g
        # the token before the ban is fed again at its own position
        slot.n_past = ban_idx - 1
        slot.pending = b""
        slot.n_streamed = min(slot.n_streamed, cum)
        return True

    def _slot_topk_ok(self, s: Slot) -> bool:
        """Eligibility for the top-k readback decode: the sampler chain must
        be prefetch-exact and the fetch must cover top_k + every distinct
        penalized token (penalties only lower logits, so coverage implies
        identical candidate membership)."""
        req = s.req
        p = req.sampler
        if s.forced or s.grammar is not None or req.n_probs > 0:
            return False
        if s.allowlist is not None and s.allowlist.active_bias() is not None:
            return False      # a bias over the whole vocabulary needs the row
        if s.elb is not None:
            return False      # expiring biases can promote any token
        if s.pos_bans and req.banned_bias > 0:
            return False
        if not topk_chain_compatible(p):
            return False
        if p.penalty_repeat != 1.0 or p.penalty_freq != 0.0 \
                or p.penalty_present != 0.0:
            # exactness relies on penalties only LOWERING logits
            if p.penalty_repeat < 1.0 or p.penalty_freq < 0.0 \
                    or p.penalty_present < 0.0:
                return False
            window = p.penalty_last_n if p.penalty_last_n > 0 \
                else len(s.tokens)
            need = max(p.top_k, p.min_keep) + min(window, len(s.tokens))
        else:
            need = max(p.top_k, p.min_keep)
        # a rewind's bans at this position push that many tokens down
        need += len(s.pos_bans.get(len(s.tokens), ()))
        return need <= min(TOPK_FETCH, self.cfg.n_vocab)

    def run_loop(self):
        """Engine loop wrapper: an exception fails the requests the engine
        was serving (each carries the error text, ``n_failed`` counts them)
        and the engine keeps serving."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                self._run_loop_inner()
                return
            except Exception as e:
                traceback.print_exc()
                msg = f"{type(e).__name__}: {e}"
                for s in self.slots:
                    if s.req is not None:
                        self._fail(s, msg)

    def step(self) -> bool:
        """One round of the loop: admit, one prefill round, one decode step
        of every generating slot. Returns False when there was nothing to
        do."""
        did = self._run_commands()
        self._admit()
        prefills = [s for s in self.slots if s.state == SlotState.PREFILL]
        if prefills:
            # one chunk round a loop iteration: ongoing decodes interleave
            # between prompt chunks
            self._do_prefill_batch(prefills)
            self._admit()
        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not gen:
            return bool(prefills) or did
        drafts = {}
        if self.spec is not None:
            for s in gen:
                if s.drafter is None:
                    s.drafter = DRAFTERS[self.spec]()
                d = s.drafter.propose(s.tokens, self.spec_n) or []
                if d:
                    drafts[s.idx] = list(d[:self.spec_n])
        if drafts and all(s.n_past + self.spec_n + 2 < self.capacity for s in gen):
            self._decode_speculative(gen, drafts)
        else:
            self._decode(gen)
        return True

    def _run_loop_inner(self):
        while not self._stop.is_set():
            if not self.step():
                time.sleep(0.002)

    def _decode(self, gen: list):
        """One decode step over every row, each at its own position."""
        toks = np.zeros((self.n_slots, 1), np.int64)
        n_past = [self._junk_row(s, 1) for s in self.slots]
        n_valid = [0] * self.n_slots
        for s in gen:
            toks[s.idx, 0] = s.tokens[-1]
            n_past[s.idx] = s.n_past
            n_valid[s.idx] = 1
        use_topk = all(self._slot_topk_ok(s) for s in gen)
        logits = self._forward(toks, self.kv, n_past, n_valid)[:, -1]
        self.n_decode_steps += 1
        if use_topk:
            self.n_topk_steps += 1
            vals, idx, lse = topk_readback(logits, min(TOPK_FETCH, self.cfg.n_vocab))
        else:
            logits_np = logits.cpu().numpy()
        for s in gen:
            s.n_past += 1
            if s.n_past >= self.capacity - 1:
                if not self._context_shift(s):
                    continue          # re-prefilled: this step's logits go
            if use_topk:
                self._emit_token(s, None, topk=(vals[s.idx], idx[s.idx],
                                                float(lse[s.idx])))
            else:
                self._emit_token(s, logits_np[s.idx])

    def _decode_speculative(self, gen: list, drafts: dict):
        """Verify the drafts in one forward over every row: a generating row
        carries [last token | draft], its length the row's ``n_valid``; an
        idle row writes junk at its _junk_row. The token sampled at
        position j is accepted while it equals draft[j]
        (server-context.cpp:3564-3599). The step's capacity rule keeps every
        row's n_past below capacity - 1, so no context shift falls inside a
        block. A recurrent model's partially accepting rows are then
        replayed from the pre-verify checkpoint (``_fix_recurrent_state``)."""
        w = 1 + self.spec_n
        toks = np.zeros((self.n_slots, w), np.int64)
        n_past = [self._junk_row(s, w) for s in self.slots]
        n_valid = [0] * self.n_slots
        for s in gen:
            d = drafts.get(s.idx, [])
            toks[s.idx, 0] = s.tokens[-1]
            toks[s.idx, 1:1 + len(d)] = d
            n_past[s.idx] = s.n_past
            n_valid[s.idx] = 1 + len(d)
        ckpt = self.kv.checkpoint() if self.rt.recurrent else None
        use_topk = all(self._slot_topk_ok(s) for s in gen)
        logits = self._forward(toks, self.kv, n_past, n_valid)       # (B, W, V)
        self.n_decode_steps += 1
        self.n_spec_steps += 1
        if use_topk:
            # B x W x (K+1) floats read back instead of B x W x V
            self.n_topk_steps += 1
            vals, idx, lse = topk_readback(logits, min(TOPK_FETCH, self.cfg.n_vocab))
        else:
            logits_np = logits.cpu().numpy()
        consumed = {}
        for s in gen:
            d = drafts.get(s.idx, [])
            self.n_draft_proposed += len(d)
            pos = acc = 0
            while s.state == SlotState.GENERATING:
                s.n_past += 1         # the row of the token at pos is written
                prev = len(s.tokens)
                if use_topk:
                    rewound = self._emit_token(s, None, topk=(
                        vals[s.idx, pos], idx[s.idx, pos], float(lse[s.idx, pos])))
                else:
                    rewound = self._emit_token(s, logits_np[s.idx, pos])
                if (rewound or pos >= len(d) or len(s.tokens) == prev
                        or s.tokens[prev] != d[pos]):
                    break
                self.n_draft_accepted += 1
                acc += 1
                pos += 1
            if hasattr(s.drafter, "accept"):
                s.drafter.accept(acc)
            consumed[s.idx] = 1 + acc
        if ckpt is not None:
            self._fix_recurrent_state(ckpt, toks, n_past, n_valid, consumed)

    def _fix_recurrent_state(self, ckpt, toks, n_past, n_valid, consumed):
        """Each generating row that consumed fewer tokens than its verify
        fed the state: its conv tail and delta state go back to the
        checkpoint and take its accepted prefix again, in one forward of
        that row alone (the K/V rows it writes are the verify's own)."""
        for i, c in consumed.items():
            if c >= n_valid[i]:
                continue
            self.kv.restore(ckpt, i)
            self._forward(toks[i:i + 1, :c], cache_rows(self.kv, i), [n_past[i]], [c])

    def _context_shift(self, slot: Slot) -> bool:
        """Out of cache: keep the prompt head, discard the oldest half of
        the rest. A shiftable model with a bf16 cache K-shifts the slot's
        row in place (runtime/kshift.k_shift on a view of the row) and
        returns True: the step's logits still stand for the next token.
        Otherwise the kept tokens are prefilled again (returns False)."""
        from ..runtime.kshift import can_shift, k_shift
        req = slot.req
        n_keep = min(slot.n_prompt, self.capacity // 4)
        if req is not None and req.n_keep >= 0:
            # at least one token is always discarded
            n_keep = max(0, min(req.n_keep, slot.n_past - 4))
        n_rest = slot.n_past - n_keep
        n_discard = max(1, n_rest // 2)
        if req is not None and req.n_discard > 0:
            n_discard = max(1, min(req.n_discard, n_rest))
        kept = (slot.tokens[:n_keep]
                + slot.tokens[n_keep + n_discard:])
        slot.n_shifts += 1
        slot.drafter = None           # its state indexes the tokens before the shift
        if req is not None:
            # a shift renumbers the positions: the bans' positions and the
            # pieces' alignment with the tokens no longer hold
            slot.pos_bans = {}
            req.banned_strings, req.banned_regex, req.banned_regex_ci = [], [], []
        if can_shift(self.cfg) and not self.rt.kv_quant and not isinstance(self.kv, SwaKVCache):
            _, new_past = k_shift(cache_rows(self.kv, slot.idx), self.cfg,
                                  n_keep, n_discard, slot.n_past)
            slot.tokens = kept
            slot.n_past = new_past
            slot.cache_tokens = kept[:new_past]
            return True
        slot.tokens = kept
        slot.n_prompt = len(kept)       # everything kept is "prompt" now
        slot.cache_tokens = []
        slot.n_past = 0
        if self.rt.recurrent:
            self.kv.zero_row(slot.idx)
        slot.state = SlotState.PREFILL
        return False

    # ------------------------------------------------------- slot state IO
    def _run_commands(self) -> bool:
        """Run the queued slot commands; True if there was one."""
        did = False
        while True:
            try:
                cmd = self._commands.get_nowait()
            except queue.Empty:
                return did
            cmd()
            did = True

    def _call(self, fn, *args):
        """``fn(*args)`` on the loop thread between two steps (here and now
        when no loop thread runs, as when a caller drives ``step``): the
        forwards write the cache in place. Returns its result or raises its
        error."""
        if not self.alive or threading.current_thread() is self._thread:
            return fn(*args)
        done, box = threading.Event(), {}

        def run():
            try:
                box["out"] = fn(*args)
            except Exception as e:          # noqa: BLE001 - raised in the caller
                box["err"] = e
            finally:
                done.set()

        self._commands.put(run)
        while not done.wait(0.05):
            if not self.alive:
                raise RuntimeError("the engine stopped before the queued command ran")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def save_slot(self, idx: int, path: str) -> dict:
        """Write slot ``idx``'s cached tokens and their KV rows to ``path``
        (the server's /slots/{id}?action=save): an idle slot's
        ``cache_tokens``, a busy one's ``tokens[:n_past]``."""
        return self._call(self._save_slot, idx, str(path))

    def _save_slot(self, idx: int, path: str) -> dict:
        from ..runtime.state import save_state
        slot = self.slots[idx]
        if slot.weights_epoch != self.weights_epoch:
            toks = []                 # rows made under other weights
        elif slot.state == SlotState.IDLE:
            toks = list(slot.cache_tokens)
        else:
            toks = slot.tokens[:slot.n_past]
        t0 = time.perf_counter()
        nbytes = save_state(path, toks, len(toks), cache_rows(self.kv, idx), rows_exact=True)
        return {"id_slot": idx, "filename": path, "n_saved": len(toks), "n_written": nbytes,
                "timings": {"save_ms": (time.perf_counter() - t0) * 1e3}}

    def restore_slot(self, idx: int, path: str) -> dict:
        """Write a saved state's rows into idle slot ``idx`` and take its
        tokens as the slot's cached ones (action=restore); a busy slot
        raises ValueError. A file the JAX engine wrote gives its tokens
        less the last (``runtime/state.restored_tokens``)."""
        return self._call(self._restore_slot, idx, str(path))

    def _restore_slot(self, idx: int, path: str) -> dict:
        from ..runtime.state import load_state, read_state_meta, restored_tokens
        slot = self.slots[idx]
        if slot.state != SlotState.IDLE:
            raise ValueError(f"slot {idx} is busy: a state is restored into an idle slot")
        meta = read_state_meta(path)
        if meta is None:
            raise ValueError(f"{path} is not a state file")
        if meta["n_past"] > self.capacity - 1:
            raise ValueError(f"the state holds {meta['n_past']} tokens; a slot holds "
                             f"{self.capacity - 1}")
        t0 = time.perf_counter()
        slot.cache_tokens = []        # its rows are overwritten below
        load_state(path, cache_rows(self.kv, idx))
        slot.cache_tokens = restored_tokens(meta)
        slot.weights_epoch = self.weights_epoch
        slot.drafter = None
        return {"id_slot": idx, "filename": path, "n_restored": len(slot.cache_tokens),
                "timings": {"restore_ms": (time.perf_counter() - t0) * 1e3}}

    def erase_slot(self, idx: int) -> dict:
        """Forget slot ``idx``'s cached tokens (action=erase)."""
        return self._call(self._erase_slot, idx)

    def _erase_slot(self, idx: int) -> dict:
        slot = self.slots[idx]
        n = len(slot.cache_tokens)
        slot.cache_tokens = []
        return {"id_slot": idx, "n_erased": n}

    # ------------------------------------------------------------- metrics
    def metrics_text(self) -> str:
        lines = [
            "# TYPE llamacpp:prompt_tokens_total counter",
            f"llamacpp:prompt_tokens_total {self.n_prompt_tokens_processed}",
            "# TYPE llamacpp:prompt_tokens_cached counter",
            f"llamacpp:prompt_tokens_cached {self.n_prompt_tokens_cached}",
            *([
                "# TYPE llamacpp:prompt_cache_ram_hits counter",
                f"llamacpp:prompt_cache_ram_hits {self.prompt_cache.n_hits}",
                "# TYPE llamacpp:prompt_cache_ram_bytes gauge",
                f"llamacpp:prompt_cache_ram_bytes {self.prompt_cache.size_bytes}",
            ] if self.prompt_cache is not None else []),
            "# TYPE llamacpp:tokens_predicted_total counter",
            f"llamacpp:tokens_predicted_total {self.n_tokens_predicted}",
            "# TYPE llamacpp:requests_total counter",
            f"llamacpp:requests_total {self.n_requests}",
            "# TYPE llamacpp:requests_failed_total counter",
            f"llamacpp:requests_failed_total {self.n_failed}",
            "# TYPE llamacpp:slots_idle gauge",
            f"llamacpp:slots_idle {sum(1 for s in self.slots if s.state == SlotState.IDLE)}",
            "# TYPE llamacpp:slots_processing gauge",
            f"llamacpp:slots_processing {sum(1 for s in self.slots if s.state != SlotState.IDLE)}",
            "# TYPE llamacpp:rewinds_total counter",
            f"llamacpp:rewinds_total {self.n_rewinds}",
            "# TYPE llamacpp:topk_decode_steps_total counter",
            f"llamacpp:topk_decode_steps_total {self.n_topk_steps}",
            "# TYPE llamacpp:decode_steps_total counter",
            f"llamacpp:decode_steps_total {self.n_decode_steps}",
            "# TYPE llamacpp:draft_tokens_total counter",
            f"llamacpp:draft_tokens_total {self.n_draft_proposed}",
            "# TYPE llamacpp:draft_tokens_accepted_total counter",
            f"llamacpp:draft_tokens_accepted_total {self.n_draft_accepted}",
        ]
        return "\n".join(lines) + "\n"
