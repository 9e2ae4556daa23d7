"""Tokenizers built from GGUF vocab metadata: SPM (sentencepiece-BPE),
GPT-2-style byte-level BPE, WordPiece (bert), unigram (t5) and RWKV.

The torch port's copy of the JAX package's ``runtime/tokenizer.py``. The
behavioural contract mirrors the reference's llm_tokenizer_spm /
llm_tokenizer_bpe / _wpm / _ugm / _rwkv (src/llama-vocab.cpp): the same
greedy bigram merges with vocab scores (SPM), the same byte-to-unicode table
and merge ranks (BPE), the same special-token splitting and byte fallback.

It differs in two ways. The BPE pre-tokenizer patterns run on the standard
library's ``re``: the ``\\p{L}`` / ``\\p{N}`` / ``\\p{P}`` classes are built
from ``unicodedata`` categories, and ``\\s`` is the Unicode White_Space set
(which ``re``'s own ``\\s`` is not: it adds U+001C-U+001F). And SPM runs
the Python merge loop alone (no native core).
"""
from __future__ import annotations

import functools
import heapq
import re
import unicodedata
from dataclasses import dataclass
from typing import Iterable

import numpy as np

# token types (llama.h llama_token_type)
TT_UNDEFINED, TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_USER_DEFINED, TT_UNUSED, TT_BYTE = range(7)

_SPACE = "▁"  # ▁


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte->unicode bijection (tiktoken/gpt2 convention)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}

# the Unicode White_Space code points (a class body): what the reference's
# \s matches
_WHITE_SPACE = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@functools.lru_cache(maxsize=1)
def _category_classes() -> dict[str, str]:
    """Character-class bodies (ranges as \\U escapes) of the code points
    whose general category starts with L, N or P, from ``unicodedata``."""
    ranges: dict[str, list] = {"L": [], "N": [], "P": []}
    for cp in range(0x110000):
        r = ranges.get(unicodedata.category(chr(cp))[0])
        if r is None:
            continue
        if r and r[-1][1] == cp - 1:
            r[-1][1] = cp
        else:
            r.append([cp, cp])
    return {k: "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                       for a, b in v) for k, v in ranges.items()}


def _to_re(expr: str) -> str:
    """A pre-tokenizer pattern in the reference's dialect (\\p{L}, \\p{N},
    \\p{P}; \\s as White_Space) rewritten for ``re``."""
    cls = _category_classes()
    out, i, in_class = [], 0, False
    while i < len(expr):
        c = expr[i]
        if c == "\\":
            nxt = expr[i + 1]
            if nxt == "p":
                body = cls[expr[i + 3]]
                assert expr[i + 2] == "{" and expr[i + 4] == "}", expr
                out.append(body if in_class else f"[{body}]")
                i += 5
                continue
            if nxt == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif nxt == "S":
                assert not in_class, expr
                out.append(f"[^{_WHITE_SPACE}]")
            else:
                out.append(expr[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _wpm_preprocess(text: str) -> list[str]:
    """BERT basic tokenization: NFD + strip accents + lowercase + isolate
    punctuation and CJK characters, split on whitespace."""
    text = unicodedata.normalize("NFD", text)
    out = []
    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":
            continue            # strip accents
        cp = ord(ch)
        is_cjk = (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
                  0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)
        is_punct = cat.startswith("P") or \
            (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or
             123 <= cp <= 126)
        if is_cjk or is_punct:
            out.append(" ")
            out.append(ch.lower())
            out.append(" ")
        elif cat.startswith("Z") or ch in " \t\n\r":
            out.append(" ")
        elif cat in ("Cc", "Cf"):
            continue
        else:
            out.append(ch.lower())
    return "".join(out).split()

_GPT2_RE = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_LLAMA3_RE = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
              r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
              r"\s+(?!\S)|\s+")
_CJK = r"[\u4E00-\u9FA5\u0800-\u4E00\uAC00-\uD7FF]+"

# per-`tokenizer.ggml.pre` regex lists, applied sequentially like the
# reference's unicode_regex_split (llama-vocab.cpp:280-400)
_PRE_EXPRS: dict[str, list[str]] = {
    "default": [_GPT2_RE],
    "gpt-2": [_GPT2_RE],
    "gpt2": [_GPT2_RE],
    "mpt": [_GPT2_RE],
    "olmo": [_GPT2_RE],
    "jais": [_GPT2_RE],
    "llama3": [_LLAMA3_RE],
    "llama-v3": [_LLAMA3_RE],
    "llama-bpe": [_LLAMA3_RE],
    "falcon": [r"[\p{P}\$\+<=>\^~\|`]+",
               r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
               r"[0-9][0-9][0-9]"],
    "starcoder": [r"\p{N}", _GPT2_RE],
    "refact": [r"\p{N}", _GPT2_RE],
    "command-r": [r"\p{N}", _GPT2_RE],
    "smaug-bpe": [r"\p{N}", _GPT2_RE],
    "deepseek-coder": [r"[\r\n]", r"\s?\p{L}+", r"\s?\p{P}+", _CJK,
                      r"\p{N}"],
    "deepseek-llm": [r"[\r\n]",
                     r"\s?[A-Za-z\u00B5\u00C0-\u00D6\u00D8-\u00F6\u00F8-\u01BA]+",
                     r"\s?[!-/:-~\uFF01-\uFF0F\uFF1A-\uFF5E\u2018-\u201F\u3000-\u3002]+",
                     r"\s+$", _CJK, r"\p{N}+"],
    "qwen2": [r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "stablelm2": [r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
}


@functools.lru_cache(maxsize=None)
def _compiled(expr: str):
    return re.compile(_to_re(expr))


class _Pretok:
    """BPE pre-tokenizer: the reference applies a per-`pre` list of regexes
    sequentially, each splitting every current piece into matches + gaps
    (unicode_regex_split, src/unicode.cpp). The unicode property classes the
    reference implements by hand are built from ``unicodedata`` here."""

    def __init__(self, kind: str):
        exprs = _PRE_EXPRS.get(kind, _PRE_EXPRS["default"])
        self.pats = [_compiled(e) for e in exprs]

    def __call__(self, text: str) -> list[str]:
        pieces = [text]
        for pat in self.pats:
            nxt: list[str] = []
            for p in pieces:
                last = 0
                for m in pat.finditer(p):
                    if m.start() > last:
                        nxt.append(p[last:m.start()])
                    if m.group():
                        nxt.append(m.group())
                    last = m.end()
                if last < len(p):
                    nxt.append(p[last:])
            pieces = nxt
        return pieces

@dataclass
class Tokenizer:
    model: str                    # 'llama' (spm) | 'gpt2' (bpe)
    tokens: list[str]
    scores: np.ndarray | None
    token_types: np.ndarray | None
    merges: list[str] | None
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    pre: str = "default"
    fim_pre_id: int = -1      # fill-in-middle specials (llama.h FIM tokens)
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    chat_template: str | None = None
    remove_extra_whitespaces: bool = False   # UGM shall_merge_spaces
    precompiled_charsmap: bytes | None = None  # UGM xcda normalization blob

    def __post_init__(self):
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self._bpe_cache: dict[str, list[int]] = {}
        self.byte_tokens: dict[int, int] = {}
        if self.token_types is not None:
            for i, tt in enumerate(self.token_types):
                if tt == TT_BYTE:
                    s = self.tokens[i]
                    if s.startswith("<0x") and s.endswith(">"):
                        self.byte_tokens[int(s[3:-1], 16)] = i
        self.specials = []
        self.user_specials = []     # USER_DEFINED: always partitioned, even
        if self.token_types is not None:   # with parse_special=False
            for i, tt in enumerate(self.token_types):
                if tt in (TT_CONTROL, TT_USER_DEFINED) and self.tokens[i]:
                    self.specials.append(self.tokens[i])
                    if tt == TT_USER_DEFINED:
                        self.user_specials.append(self.tokens[i])
        self.specials.sort(key=len, reverse=True)
        self.user_specials.sort(key=len, reverse=True)
        if self.merges:
            self.merge_ranks = {}
            for rank, m in enumerate(self.merges):
                a, _, b = m.partition(" ")
                self.merge_ranks[(a, b)] = rank
        self._pretok_fn = None

    # ------------------------------------------------------------------ SPM
    def _spm_encode_piece(self, text: str) -> list[int]:
        # symbols = utf-8 characters; greedy best-score bigram merge
        syms = list(text)
        if not syms:
            return []
        scores = self.scores
        heap = []

        def try_pair(i, j, left_idx):
            pair = "".join(syms_txt[i:j + 1])
            tid = self.vocab.get(pair)
            return tid

        # linked-list merge like the reference
        syms_txt = syms
        nxt = list(range(1, len(syms) + 1))
        prv = list(range(-1, len(syms) - 1))
        alive = [True] * len(syms)
        text_of = syms[:]

        def push(i):
            j = nxt[i]
            if j >= len(syms) or not alive[i]:
                return
            merged = text_of[i] + text_of[j]
            tid = self.vocab.get(merged)
            if tid is not None and scores is not None:
                heapq.heappush(heap, (-float(scores[tid]), i, merged))

        for i in range(len(syms)):
            push(i)
        while heap:
            negscore, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j >= len(syms) or not alive[j] or text_of[i] + text_of[j] != merged:
                continue
            text_of[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(syms):
                prv[nxt[i]] = i
            push(i)
            if prv[i] >= 0:
                push(prv[i])
        out = []
        i = 0
        while i < len(syms):
            if alive[i]:
                piece = text_of[i]
                tid = self.vocab.get(piece)
                if tid is not None:
                    out.append(tid)
                else:
                    for byte in piece.encode("utf-8"):
                        out.append(self.byte_tokens.get(byte, self.unk_id))
                i = nxt[i]
            else:
                i += 1
        return out

    def _encode_spm(self, text: str) -> list[int]:
        if not text:
            return []
        raw = text
        if self.add_space_prefix and raw:
            raw = " " + raw
        raw = raw.replace(" ", _SPACE)
        return self._spm_encode_piece(raw)

    # ------------------------------------------------------------------ BPE
    def _bpe_word(self, word: str) -> list[int]:
        # BPE merges never cross the pre-tokenizer's word boundaries, so a
        # per-word cache is EXACT — and word frequency is Zipfian, making
        # long-prompt encoding mostly cache hits (same trick as tiktoken)
        cached = self._bpe_cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        out = []
        for p in parts:
            tid = self.vocab.get(p)
            if tid is not None:
                out.append(tid)
            else:
                for chu in p:
                    tid = self.vocab.get(chu)
                    if tid is not None:
                        out.append(tid)
                    elif self.unk_id >= 0:
                        out.append(self.unk_id)
        if len(self._bpe_cache) < 1 << 16:
            self._bpe_cache[word] = out
        return out

    def _encode_bpe(self, text: str) -> list[int]:
        out = []
        if self._pretok_fn is None:
            self._pretok_fn = _Pretok(self.pre)
        for frag in self._pretok_fn(text):
            mapped = "".join(_BYTE_ENC[b] for b in frag.encode("utf-8"))
            out.extend(self._bpe_word(mapped))
        return out

    # ------------------------------------------------------------- public
    def encode(self, text: str, *, add_bos: bool | None = None,
               add_eos: bool | None = None, parse_special: bool = True) -> list[int]:
        add_bos = self.add_bos if add_bos is None else add_bos
        add_eos = self.add_eos if add_eos is None else add_eos
        core = self._encode_with_specials(text) if parse_special else self._encode_raw(text)
        ids = ([self.bos_id] if (add_bos and self.bos_id >= 0) else []) + core
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def _encode_plain(self, text: str) -> list[int]:
        if self.model == "llama":
            return self._encode_spm(text)
        if self.model == "bert":
            return self._encode_wpm(text)
        if self.model == "t5":
            return self._encode_ugm(text)
        if self.model == "rwkv":
            return self._encode_rwkv(text)
        return self._encode_bpe(text)

    # ----------------------------------------------------------------- RWKV
    def _rwkv_bytes(self):
        r"""Unescaped byte strings per token (llama_unescape_rwkv_token,
        llama-vocab.cpp:1189: \t \n \r \xHH and \\ escapes)."""
        if not hasattr(self, "_rwkv_tok_bytes"):
            def unescape(t: str) -> bytes:
                out = bytearray()
                i = 0
                while i < len(t):
                    c = t[i]
                    if c == "\\" and i + 1 < len(t):
                        n = t[i + 1]
                        if n == "t":
                            out.append(9)
                        elif n == "n":
                            out.append(10)
                        elif n == "r":
                            out.append(13)
                        elif n == "x" and i + 3 < len(t):
                            out.append(int(t[i + 2:i + 4], 16))
                            i += 4
                            continue
                        else:
                            out.append(ord(n))
                        i += 2
                    else:
                        out.extend(c.encode("utf-8"))
                        i += 1
                return bytes(out)
            toks = [unescape(t) for t in self.tokens]
            # prefix map byte->candidate ids sorted by length desc
            by_first: dict[int, list[int]] = {}
            for tid, b in enumerate(toks):
                if b:
                    by_first.setdefault(b[0], []).append(tid)
            for k in by_first:
                by_first[k].sort(key=lambda tid: -len(toks[tid]))
            self._rwkv_tok_bytes = toks
            self._rwkv_by_first = by_first
        return self._rwkv_tok_bytes, self._rwkv_by_first

    def _encode_rwkv(self, text: str) -> list[int]:
        r"""Greedy longest-match over raw bytes (llm_tokenizer_rwkv trie,
        llama-vocab.cpp:1243-1290); unmatched byte -> unk."""
        toks, by_first = self._rwkv_bytes()
        data = text.encode("utf-8")
        out: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            best = -1
            for tid in by_first.get(data[pos], ()):
                tb = toks[tid]
                if data[pos:pos + len(tb)] == tb:
                    best = tid
                    break          # candidates sorted longest-first
            if best < 0:
                out.append(self.unk_id if self.unk_id >= 0 else 0)
                pos += 1
            else:
                out.append(best)
                pos += len(toks[best])
        return out

    # ------------------------------------------------------------------ WPM
    def _encode_wpm(self, text: str) -> list[int]:
        """WordPiece (llm_tokenizer_wpm, src/llama-vocab.cpp): lowercase +
        strip accents, isolate punctuation/CJK, then greedy longest-match
        per word with word-start pieces stored as \u2581-prefixed."""
        words = _wpm_preprocess(text)
        out = []
        for word in words:
            s = "\u2581" + word
            ids = []
            i = 0
            while i < len(s):
                j = len(s)
                tid = None
                while j > i:
                    cand = s[i:j] if i == 0 else s[i:j]
                    t = self.vocab.get(cand)
                    if t is not None:
                        tid = t
                        break
                    j -= 1
                if tid is None:
                    ids = None
                    break
                ids.append(tid)
                i = j
            if ids is None:
                if self.unk_id >= 0:
                    out.append(self.unk_id)
            else:
                out.extend(ids)
        return out

    # ------------------------------------------------------------------ UGM
    def _ugm_init(self):
        """Lazy setup for the T5/SentencePiece unigram tokenizer
        (llm_tokenizer_ugm, src/llama-vocab.cpp:839-1060)."""
        toks: dict[bytes, tuple[int, float]] = {}
        min_score = float("inf")
        tt = self.token_types
        user_defined: list[bytes] = []
        for i, t in enumerate(self.tokens):
            ty = int(tt[i]) if tt is not None else TT_NORMAL
            b = t.encode("utf-8")
            if ty == TT_NORMAL and self.scores is not None:
                min_score = min(min_score, float(self.scores[i]))
            if ty == TT_NORMAL:
                toks[b] = (i, float(self.scores[i]) if self.scores is not None else 0.0)
            elif ty in (TT_USER_DEFINED, TT_UNUSED):
                # user-defined tokens score 0 to be preferred over normal ones
                toks[b] = (i, 0.0)
                if ty == TT_USER_DEFINED:
                    user_defined.append(b)
        self._ugm_tokens = toks
        self._ugm_maxlen = max((len(b) for b in toks), default=1)
        self._ugm_unk_score = (min_score if min_score != float("inf") else 0.0) - 10.0
        self._ugm_user_defined = sorted(user_defined, key=len, reverse=True)
        # precompiled charsmap: [u32 xcda_size][xcda u32s][replacement strings]
        self._ugm_xcda = None
        self._ugm_repl = b""
        cm = self.precompiled_charsmap
        if cm and len(cm) >= 4:
            xcda_size = int.from_bytes(cm[:4], "little")
            if xcda_size + 4 <= len(cm):
                self._ugm_xcda = np.frombuffer(cm[4:4 + xcda_size], np.uint32)
                self._ugm_repl = cm[4 + xcda_size:]

    @staticmethod
    def _utf8_len(b0: int) -> int:
        if b0 < 0x80:
            return 1
        if b0 < 0xE0:
            return 2 if b0 >= 0xC0 else 1
        if b0 < 0xF0:
            return 3
        return 4

    def _ugm_normalize_prefix(self, data: bytes, off: int):
        """Returns (normalized_bytes, consumed). Mirrors normalize_prefix
        (llama-vocab.cpp:1110-1179): user-defined passthrough, then longest
        XCDA charsmap replacement, else the raw UTF-8 code point."""
        for ud in self._ugm_user_defined:
            if data.startswith(ud, off):
                return data[off:off + len(ud)], len(ud)
        xcda = self._ugm_xcda
        best_len, best_off = 0, 0
        if xcda is not None and xcda.size:
            def base(i):
                n = int(xcda[i])
                return (n >> 10) << ((n & (1 << 9)) >> 6)
            def lcheck(i):
                n = int(xcda[i])
                return n & ((1 << 31) | 0xFF)
            def leaf(i):
                return (int(xcda[i]) >> 8) & 1
            def value(i):
                return int(xcda[i]) & ((1 << 31) - 1)
            node = base(0)
            for p in range(off, len(data)):
                c = data[p]
                if c == 0:
                    break
                node ^= c
                if node >= xcda.size or lcheck(node) != c:
                    break
                is_leaf = leaf(node)
                node ^= base(node)
                if is_leaf:
                    best_len = p - off + 1
                    best_off = value(node)
        if best_len > 0:
            end = self._ugm_repl.index(b"\0", best_off) \
                if b"\0" in self._ugm_repl[best_off:] else len(self._ugm_repl)
            return self._ugm_repl[best_off:end], best_len
        n = min(self._utf8_len(data[off]), len(data) - off)
        piece = data[off:off + n]
        try:
            piece.decode("utf-8")
            return piece, n
        except UnicodeDecodeError:
            return b"\xef\xbf\xbd", 1
    
    def _ugm_normalize(self, text: str) -> bytes:
        """UGM normalization (llama-vocab.cpp:1017-1060): charsmap prefix
        replacement + space escaping to U+2581 with prefix/merge rules."""
        data = text.encode("utf-8")
        space = "\u2581".encode("utf-8")
        out = bytearray()
        prepend = self.add_space_prefix
        merge = self.remove_extra_whitespaces
        is_space_prepended = False
        processing_non_ws = False
        off = 0
        while off < len(data):
            norm, consumed = self._ugm_normalize_prefix(data, off)
            for c in norm:
                if c != 0x20:
                    if not processing_non_ws:
                        processing_non_ws = True
                        if (prepend and not is_space_prepended) or merge:
                            out.extend(space)
                            is_space_prepended = True
                    out.append(c)
                else:
                    if processing_non_ws:
                        processing_non_ws = False
                    if not merge:
                        out.extend(space)
            off += max(consumed, 1)
        return bytes(out)

    def _encode_ugm(self, text: str) -> list[int]:
        """SentencePiece unigram Viterbi (llm_tokenizer_ugm_session::tokenize,
        llama-vocab.cpp:909-1005): best-scoring segmentation over the
        normalized byte string; unmatched code points become UNK with a
        score penalty, consecutive UNKs merge."""
        if not hasattr(self, "_ugm_tokens"):
            self._ugm_init()
        norm = self._ugm_normalize(text)
        n = len(norm)
        if n == 0:
            return []
        NEG = -1e300
        best_score = [NEG] * (n + 1)
        best_tok = [self.unk_id] * (n + 1)
        best_src = [0] * (n + 1)
        best_score[0] = 0.0
        off = 0
        while off < n:
            cp_len = min(self._utf8_len(norm[off]), n - off)
            cur = best_score[off]
            single_cp_found = False
            maxe = min(n, off + self._ugm_maxlen)
            for end in range(off + 1, maxe + 1):
                hit = self._ugm_tokens.get(norm[off:end])
                if hit is None:
                    continue
                if end - off == cp_len:
                    single_cp_found = True
                tid, sc = hit
                ch = cur + sc
                if ch > best_score[end]:
                    best_score[end] = ch
                    best_tok[end] = tid
                    best_src[end] = off
            if not single_cp_found:
                end = off + cp_len
                ch = cur + self._ugm_unk_score
                if ch > best_score[end]:
                    best_score[end] = ch
                    best_tok[end] = self.unk_id
                    best_src[end] = off
            off += cp_len
        out_rev = []
        pos = n
        prev_unk = False
        while True:
            tid = best_tok[pos]
            is_unk = tid == self.unk_id
            if not (prev_unk and is_unk):
                out_rev.append(tid)
            if best_src[pos] == 0:
                break     # this token starts at 0 — done (results[0] is the
                          # sentinel start entry, never emitted)
            prev_unk = is_unk
            pos = best_src[pos]
        return list(reversed(out_rev))

    def _split_on(self, text: str, specials: list[str]) -> list[int]:
        pattern = "|".join(re.escape(s) for s in specials)
        out = []
        pos = 0
        for m in re.finditer(pattern, text):
            if m.start() > pos:
                out.extend(self._encode_plain(text[pos:m.start()]))
            out.append(self.vocab[m.group(0)])
            pos = m.end()
        if pos < len(text):
            out.extend(self._encode_plain(text[pos:]))
        return out

    def _encode_raw(self, text: str) -> list[int]:
        # USER_DEFINED tokens partition the text regardless of parse_special
        # (llama-vocab.cpp tokenizer_st_partition: only CONTROL/UNKNOWN are
        # gated on parse_special)
        if not self.user_specials:
            return self._encode_plain(text)
        return self._split_on(text, self.user_specials)

    def _encode_with_specials(self, text: str) -> list[int]:
        if not self.specials:
            return self._encode_plain(text)
        return self._split_on(text, self.specials)

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        """Raw UTF-8 bytes of the pieces — for streaming detokenization where
        a multibyte character may span tokens (the server buffers bytes until
        they form valid UTF-8, like the reference's partial-UTF8 handling)."""
        buf = bytearray()
        if self.model == "rwkv":
            toks, _ = self._rwkv_bytes()
            for i in ids:
                buf.extend(toks[i])
            return bytes(buf)
        if self.model in ("llama", "t5"):
            for i in ids:
                tt = self.token_types[i] if self.token_types is not None else TT_NORMAL
                piece = self.tokens[i]
                if tt == TT_BYTE:
                    buf.append(int(piece[3:-1], 16))
                else:
                    buf.extend(piece.replace(_SPACE, " ").encode("utf-8"))
            return bytes(buf)
        for i in ids:
            piece = self.tokens[i]
            tt = self.token_types[i] if self.token_types is not None else TT_NORMAL
            if tt in (TT_CONTROL, TT_USER_DEFINED):
                buf.extend(piece.encode("utf-8"))
            else:
                buf.extend(bytes(_BYTE_DEC.get(c, ord(" ")) for c in piece))
        return bytes(buf)

    def decode(self, ids: Iterable[int]) -> str:
        if self.model == "rwkv":
            return self.decode_bytes(ids).decode("utf-8", errors="replace")
        if self.model in ("llama", "t5"):
            buf = bytearray()
            for i in ids:
                tt = self.token_types[i] if self.token_types is not None else TT_NORMAL
                piece = self.tokens[i]
                if tt == TT_BYTE:
                    buf.append(int(piece[3:-1], 16))
                else:
                    buf.extend(piece.replace(_SPACE, " ").encode("utf-8"))
            return buf.decode("utf-8", errors="replace")
        buf = bytearray()
        for i in ids:
            piece = self.tokens[i]
            tt = self.token_types[i] if self.token_types is not None else TT_NORMAL
            if tt in (TT_CONTROL, TT_USER_DEFINED):
                buf.extend(piece.encode("utf-8"))
            else:
                buf.extend(bytes(_BYTE_DEC.get(c, ord(" ")) for c in piece))
        return buf.decode("utf-8", errors="replace")


def tokenizer_from_gguf(md: dict) -> Tokenizer:
    tokens = [str(t) for t in md["tokenizer.ggml.tokens"]]
    scores = md.get("tokenizer.ggml.scores")
    token_types = md.get("tokenizer.ggml.token_type")
    merges = md.get("tokenizer.ggml.merges")
    if merges is not None and not isinstance(merges, list):
        merges = [str(m) for m in merges]

    def geti(key, default=-1):
        v = md.get(key, default)
        return int(v.item() if hasattr(v, "item") else v)

    def getb(key, default):
        v = md.get(key, default)
        return bool(v.item() if hasattr(v, "item") else v)

    model = str(md.get("tokenizer.ggml.model", "llama"))
    cm = md.get("tokenizer.ggml.precompiled_charsmap")
    if cm is not None and not isinstance(cm, (bytes, bytearray)):
        cm = np.asarray(cm, np.uint8).tobytes()
    # UGM (t5) defaults per llama-vocab.cpp:1844-1852,2186-2189
    ugm = model == "t5"
    return Tokenizer(
        model=model,
        tokens=tokens,
        scores=None if scores is None else np.asarray(scores),
        token_types=None if token_types is None else np.asarray(token_types),
        merges=merges,
        bos_id=geti("tokenizer.ggml.bos_token_id", -1 if ugm else -1),
        eos_id=geti("tokenizer.ggml.eos_token_id", 1 if ugm else -1),
        unk_id=geti("tokenizer.ggml.unknown_token_id", 2 if ugm else -1),
        pad_id=geti("tokenizer.ggml.padding_token_id", 0 if ugm else -1),
        add_bos=getb("tokenizer.ggml.add_bos_token",
                     model == "llama" and not ugm),
        add_eos=getb("tokenizer.ggml.add_eos_token", ugm),
        # UGM/t5 defaults add_space_prefix=false (llama-vocab.cpp:1936)
        add_space_prefix=getb("tokenizer.ggml.add_space_prefix", not ugm),
        pre=str(md.get("tokenizer.ggml.pre", "default")),
        fim_pre_id=geti("tokenizer.ggml.fim_pre_token_id",
                        geti("tokenizer.ggml.prefix_token_id")),
        fim_suf_id=geti("tokenizer.ggml.fim_suf_token_id",
                        geti("tokenizer.ggml.suffix_token_id")),
        fim_mid_id=geti("tokenizer.ggml.fim_mid_token_id",
                        geti("tokenizer.ggml.middle_token_id")),
        chat_template=(str(md["tokenizer.chat_template"])
                       if "tokenizer.chat_template" in md else None),
        remove_extra_whitespaces=getb(
            "tokenizer.ggml.remove_extra_whitespaces", False),
        precompiled_charsmap=cm,
    )
