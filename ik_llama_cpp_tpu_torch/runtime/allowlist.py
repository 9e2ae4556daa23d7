"""Unicode-script allowlist biasing — the reference's
``--allowlist-unicode-rule`` / ``--allowlist-pieces`` / ``--allowlist-keyword``
family (common/common.cpp:3161-3167 options, argparse rule grammar at
common/common.cpp:5426, bias construction + keyword expiry at
examples/server/server-context.cpp:1696-1793 and 4630-4647).

A *ruleset* is a list of ``(lower_cpt, upper_cpt, script, bias)`` rules.  For
every vocab token, each of its codepoints must match at least one rule
(``script`` is a lowercase UAX #24 script name or ``"*"``); the token's bias
is the max of the first-matching rule's bias per codepoint.  A codepoint
matching no rule bans the token (``-inf``) unless its script is ``common`` or
``inherited`` (whitespace, digits, combining marks defer to the token's other
codepoints).  Rulesets expire in order as *keywords* appear in the generated
text, activating the next ruleset; one more ruleset than keywords means the
last ruleset never expires.

The per-vocab pass is vectorized: all pieces' codepoints are flattened into
one array, scripts resolved by a single ``searchsorted`` against the UCD
segment table, and each rule applied as a masked assignment over the flat
array — no per-token Python loop per ruleset.

The torch port's copy of the JAX package's ``runtime/allowlist.py``: numpy and the
standard library only, held to the JAX module by
``tests/test_torch_server_extras.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .unicode_scripts_data import (SCRIPT_NAMES, SEGMENT_LASTS,
                                   SEGMENT_SCRIPT)

_LASTS = np.asarray(SEGMENT_LASTS, np.uint32)
_SEG_SCRIPT = np.asarray(SEGMENT_SCRIPT, np.int32)
_UNKNOWN = len(SCRIPT_NAMES)          # sentinel id for cpts past the table
_NAME_TO_ID = {n: i for i, n in enumerate(SCRIPT_NAMES)}
_COMMON = _NAME_TO_ID["common"]
_INHERITED = _NAME_TO_ID["inherited"]
_UINT32_MAX = 0xFFFFFFFF


def script_of(cpt: int) -> str:
    """UAX #24 script name of one codepoint (lowercase; "unknown" past the
    table) — the analogue of unicode_fill_from_utf8's per-cpt lookup."""
    i = int(np.searchsorted(_LASTS, cpt, side="left"))
    return SCRIPT_NAMES[_SEG_SCRIPT[i]] if i < len(_LASTS) else "unknown"


def _script_ids(cpts: np.ndarray) -> np.ndarray:
    seg = np.searchsorted(_LASTS, cpts, side="left")
    ids = np.where(seg < len(_LASTS),
                   _SEG_SCRIPT[np.minimum(seg, len(_LASTS) - 1)], _UNKNOWN)
    return ids.astype(np.int32)


def parse_rule(argstr: str):
    """Parse one ``LOWER..UPPER,SCRIPT:BIAS`` rule string
    (common/common.cpp:5426 argparse_allowlist_unicode_rule).

    Any part may be omitted: bias defaults to 0, the range to the full
    codepoint space, the script to ``"*"`` when the last comma-field isn't
    purely alphabetic.  ``ascii`` is shorthand for ``0..127,*``.  Bounds are
    decimal codepoints and are swapped into order if reversed."""
    head, _, bias_s = argstr.partition(":")
    bias = float(bias_s) if bias_s else 0.0
    fields = head.split(",")
    last_field = fields[-1]
    script = last_field.lower() if last_field.isalpha() else "*"
    if script == "ascii":
        return (0x000000, 0x00007F, "*", bias)
    first, last = 0, _UINT32_MAX
    if script == "*" or len(fields) > 1:
        parts = fields[0].split(".")
        if parts and parts[0]:
            first = int(parts[0])
        if parts and parts[-1]:
            last = int(parts[-1])
    return (min(first, last), max(first, last), script, bias)


def harmonize(rulesets: list, keywords: list) -> tuple[list, list]:
    """Reconcile ruleset and keyword counts (server-context.cpp:1729-1737):
    at most one more ruleset than keywords (the final one never expires);
    excess keywords are dropped."""
    rulesets = [list(rs) for rs in rulesets]
    keywords = list(keywords)
    if len(rulesets) > len(keywords) + 1:
        rulesets = rulesets[: len(keywords) + 1]
    elif len(rulesets) < len(keywords):
        keywords = keywords[: len(rulesets)]
    return rulesets, keywords


def build_biases(vocab_cpts: "VocabCodepoints", ruleset: list,
                 allow_tokens=()) -> np.ndarray:
    """Per-vocab bias vector for one ruleset
    (server-context.cpp:1746-1791).  ``allow_tokens`` (ids from tokenizing
    ``--allowlist-pieces``) are overridden to the ruleset's max bias."""
    flat_cpt = vocab_cpts.flat_cpt
    flat_script = vocab_cpts.flat_script
    n_flat = len(flat_cpt)

    matched = np.zeros(n_flat, bool)
    cpt_bias = np.full(n_flat, -np.inf, np.float32)
    for lo, hi, script, bias in ruleset:
        in_range = (flat_cpt >= lo) & (flat_cpt <= hi)
        if script == "*":
            hit = in_range
        else:
            sid = _NAME_TO_ID.get(script, -1)
            hit = in_range & (flat_script == sid)
        new = hit & ~matched        # first matching rule wins per codepoint
        cpt_bias[new] = bias
        matched |= hit

    deferred = (flat_script == _COMMON) | (flat_script == _INHERITED)
    bad = ~matched & ~deferred      # unmatched, non-deferrable → token ban
    effective = matched             # codepoints contributing a bias

    row = vocab_cpts.flat_row
    n_vocab = vocab_cpts.n_vocab
    biases = np.full(n_vocab, -np.inf, np.float32)
    # max matched-cpt bias per token, only up to the first "bad" codepoint
    # (the reference breaks out of the cpt loop at the first violation, so
    # matched codepoints BEFORE it still don't rescue the token — the final
    # bias is overwritten to -inf; order within the token doesn't matter
    # for the ban, only for which biases were accumulated, and since the
    # ban wins regardless we can apply it row-wise)
    np.maximum.at(biases, row[effective], cpt_bias[effective])
    banned_rows = np.unique(row[bad])
    biases[banned_rows] = -np.inf

    if len(ruleset) and len(allow_tokens):
        max_bias = max(r[3] for r in ruleset)
        ids = np.asarray(sorted(set(int(t) for t in allow_tokens)), np.int64)
        ids = ids[(ids >= 0) & (ids < n_vocab)]
        biases[ids] = max_bias
    return biases


class VocabCodepoints:
    """Flattened (codepoint, script, row) view of every vocab piece, built
    once per tokenizer (the analogue of populate_vocab_pieces +
    llama_fill_from_utf8 over the vocab, server-context.cpp:1720/1753)."""

    def __init__(self, tokenizer):
        pieces = []
        for i in range(len(tokenizer.tokens)):
            raw = tokenizer.decode_bytes([i])
            pieces.append(raw.decode("utf-8", errors="replace"))
        self.n_vocab = len(pieces)
        rows, cpts = [], []
        for i, piece in enumerate(pieces):
            for ch in piece:
                rows.append(i)
                cpts.append(ord(ch))
        self.flat_row = np.asarray(rows, np.int64)
        self.flat_cpt = np.asarray(cpts, np.uint32)
        self.flat_script = _script_ids(self.flat_cpt)


@dataclass
class AllowlistState:
    """Per-slot allowlist: bias vectors per ruleset + keyword cursor
    (slot.allow_biasess / allow_idx / update_allowlist_state)."""
    biases: list = field(default_factory=list)   # np.ndarray per ruleset
    keywords: list = field(default_factory=list)
    kw_delay: int = 0
    idx: int = 0

    def active_bias(self):
        """Bias vector to add to this step's logits, or None when every
        ruleset has expired (apply_server_biases)."""
        if self.idx < len(self.biases):
            return self.biases[self.idx]
        return None

    def update(self, generated_text: str, prev_len: int,
               n_decoded: int) -> None:
        """Advance the keyword cursor for text appended since ``prev_len``
        (server-context.cpp:4630 update_allowlist_state): each found
        keyword expires its ruleset and the search continues for the next
        keyword from just past the match."""
        kws = self.keywords
        if self.kw_delay > n_decoded or self.idx >= len(kws):
            return
        kw = kws[self.idx]
        pos = generated_text.find(kw, max(0, prev_len - len(kw) + 1))
        while pos != -1:
            self.idx += 1
            if self.idx >= len(kws):
                break
            kw = kws[self.idx]
            pos = generated_text.find(kw, pos + 1)


def build_allowlist(tokenizer, rulesets, keywords, pieces=(),
                    kw_delay: int = 0,
                    vocab_cache: dict | None = None) -> AllowlistState | None:
    """Construct a slot's AllowlistState from parsed rulesets.  ``pieces``
    are tokenized (no BOS, specials parsed) and their tokens inherit each
    ruleset's max bias.  ``vocab_cache`` (keyed per tokenizer) avoids
    re-flattening the vocab and re-building identical bias vectors."""
    rulesets = [rs for rs in rulesets]
    if not rulesets or all(not rs for rs in rulesets):
        return None
    rulesets, keywords = harmonize(rulesets, keywords)
    cache = vocab_cache if vocab_cache is not None else {}
    vc = cache.get("_vocab")
    if vc is None:
        vc = VocabCodepoints(tokenizer)
        cache["_vocab"] = vc
    allow_tokens: list[int] = []
    for piece in pieces:
        allow_tokens.extend(tokenizer.encode(str(piece), add_bos=False))
    biases = []
    for rs in rulesets:
        key = (tuple(tuple(r) for r in rs), tuple(sorted(set(allow_tokens))))
        b = cache.get(key)
        if b is None:
            b = build_biases(vc, rs, allow_tokens)
            cache[key] = b
        biases.append(b)
    return AllowlistState(biases=biases, keywords=[str(k) for k in keywords],
                          kw_delay=int(kw_delay))
