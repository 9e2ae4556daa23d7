"""GBNF grammar engine — analogue of llama-grammar.cpp + grammar-parser.

Parses GBNF (the reference's grammar format: rules of alternates of
sequences; literals, char classes with ranges and negation, rule refs,
`* + ?` repetition, grouping) and provides the incremental pushdown matcher
used for constrained decoding: a set of stacks of pending grammar elements;
a character advances every stack that can consume it.

Token-level API: `accept_token` / `allows_token` operate on token text and
are plugged into the sampler (rejection-resampling, equivalent to masking).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Iterable


class ElType(Enum):
    END = 0
    ALT = 1          # separator between alternates (internal)
    RULE_REF = 2
    CHAR = 3         # char class: list of (lo, hi) codepoint ranges
    CHAR_NOT = 4     # negated char class


@dataclass(frozen=True)
class El:
    type: ElType
    value: tuple = ()  # RULE_REF: (rule_id,); CHAR/NOT: ((lo,hi),...)


# a rule is a list of alternates; an alternate is a tuple of Els
Rule = list


class GBNFParseError(ValueError):
    pass


class GrammarParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rule_ids: dict[str, int] = {}
        self.rules: dict[int, list[tuple[El, ...]]] = {}
        self._anon = 0

    # --------------------------------------------------------- lexing utils
    def _ws(self):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r\n":
                self.pos += 1
            else:
                break

    def _ws_inline(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1
        if self.pos < len(self.text) and self.text[self.pos] == "#":
            while self.pos < len(self.text) and self.text[self.pos] != "\n":
                self.pos += 1

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.text) and (
                self.text[self.pos].isalnum() or self.text[self.pos] in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GBNFParseError(f"expected name at {start}")
        return self.text[start:self.pos]

    def rule_id(self, name: str) -> int:
        if name not in self.rule_ids:
            self.rule_ids[name] = len(self.rule_ids)
        return self.rule_ids[name]

    def _char(self) -> int:
        c = self.text[self.pos]
        if c == "\\":
            self.pos += 1
            e = self.text[self.pos]
            self.pos += 1
            table = {"n": 10, "t": 9, "r": 13, '"': 34, "[": 91, "]": 93,
                     "\\": 92, "'": 39}
            if e in table:
                return table[e]
            if e == "x":
                v = int(self.text[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if e in "uU":
                ln = 4 if e == "u" else 8
                v = int(self.text[self.pos:self.pos + ln], 16)
                self.pos += ln
                return v
            raise GBNFParseError(f"bad escape \\{e}")
        self.pos += 1
        return ord(c)

    # --------------------------------------------------------- grammar
    def parse(self) -> dict[int, list]:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        # validate refs
        for rid, alts in self.rules.items():
            for alt in alts:
                for el in alt:
                    if el.type == ElType.RULE_REF and el.value[0] not in self.rules:
                        missing = [n for n, i in self.rule_ids.items()
                                   if i == el.value[0]]
                        raise GBNFParseError(f"undefined rule {missing}")
        if "root" not in self.rule_ids:
            raise GBNFParseError("missing root rule")
        return self.rules

    def _parse_rule(self):
        name = self._name()
        rid = self.rule_id(name)
        self._ws()
        if self.text[self.pos:self.pos + 3] == "::=":
            self.pos += 3
        else:
            raise GBNFParseError(f"expected ::= after {name}")
        self._ws()
        alts = self._parse_alternates(name)
        self.rules[rid] = alts

    def _parse_alternates(self, base: str, stop: str = "") -> list[tuple[El, ...]]:
        alts = [tuple(self._parse_sequence(base, stop))]
        while True:
            self._ws_inline()
            # alternates may continue on next line after |
            save = self.pos
            self._ws()
            if self.pos < len(self.text) and self.text[self.pos] == "|":
                self.pos += 1
                self._ws()
                alts.append(tuple(self._parse_sequence(base, stop)))
            else:
                self.pos = save
                break
        return alts

    def _parse_sequence(self, base: str, stop: str) -> list[El]:
        seq: list[El] = []
        while True:
            self._ws_inline()
            if self.pos >= len(self.text):
                break
            c = self.text[self.pos]
            if c == "\n":
                if not stop:        # top level: newline ends the rule
                    break
                self._ws()          # inside (...) newlines are whitespace
                continue
            if stop and c == stop:
                break
            if c == "|":
                break
            el = self._parse_element(base)
            self._ws_inline()
            # repetition suffix
            if self.pos < len(self.text) and self.text[self.pos] in "*+?":
                op = self.text[self.pos]
                self.pos += 1
                el = self._make_repetition(base, [el], op)
                seq.append(el)
            elif self.pos < len(self.text) and self.text[self.pos] == "{":
                # bounded repetition {m} / {m,} / {m,n} (GBNF extension)
                end = self.text.index("}", self.pos)
                spec = self.text[self.pos + 1: end]
                self.pos = end + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
                seq.extend([el] * lo)
                if hi is None:
                    seq.append(self._make_repetition(base, [el], "*"))
                else:
                    for _ in range(hi - lo):
                        seq.append(self._make_repetition(base, [el], "?"))
            else:
                seq.append(el)
        return seq

    def _parse_element(self, base: str) -> El:
        c = self.text[self.pos]
        if c == '"':
            self.pos += 1
            chars = []
            while self.text[self.pos] != '"':
                chars.append(self._char())
            self.pos += 1
            if len(chars) == 1:
                return El(ElType.CHAR, ((chars[0], chars[0]),))
            # literal string -> anon rule with a char sequence
            rid = self._anon_rule([tuple(El(ElType.CHAR, ((ch, ch),))
                                         for ch in chars)], base)
            return El(ElType.RULE_REF, (rid,))
        if c == "[":
            self.pos += 1
            neg = False
            if self.text[self.pos] == "^":
                neg = True
                self.pos += 1
            ranges = []
            while self.text[self.pos] != "]":
                lo = self._char()
                if self.text[self.pos] == "-" and self.text[self.pos + 1] != "]":
                    self.pos += 1
                    hi = self._char()
                else:
                    hi = lo
                ranges.append((lo, hi))
            self.pos += 1
            return El(ElType.CHAR_NOT if neg else ElType.CHAR, tuple(ranges))
        if c == "(":
            self.pos += 1
            self._ws()
            alts = self._parse_alternates(base, stop=")")
            self._ws()
            if self.text[self.pos] != ")":
                raise GBNFParseError("expected )")
            self.pos += 1
            rid = self._anon_rule(alts, base)
            return El(ElType.RULE_REF, (rid,))
        # rule reference
        name = self._name()
        return El(ElType.RULE_REF, (self.rule_id(name),))

    def _anon_rule(self, alts, base: str) -> int:
        self._anon += 1
        rid = self.rule_id(f"{base}_{self._anon}")
        self.rules[rid] = alts
        return rid

    def _make_repetition(self, base: str, seq: list[El], op: str) -> El:
        """x* -> r ::= x r | ; x+ -> r ::= x r | x; x? -> r ::= x |"""
        self._anon += 1
        rid = self.rule_id(f"{base}_{self._anon}")
        x = tuple(seq)
        ref = El(ElType.RULE_REF, (rid,))
        if op == "*":
            self.rules[rid] = [x + (ref,), ()]
        elif op == "+":
            self.rules[rid] = [x + (ref,), x]
        else:
            self.rules[rid] = [x, ()]
        return ref


def _char_match(el: El, cp: int) -> bool:
    hit = any(lo <= cp <= hi for lo, hi in el.value)
    return not hit if el.type == ElType.CHAR_NOT else hit


class Grammar:
    """Incremental matcher: a set of stacks of pending elements (top = next)."""

    def __init__(self, gbnf: str, root: str = "root"):
        p = GrammarParser(gbnf)
        self.rules = p.parse()
        self.root_id = p.rule_ids[root]
        self.stacks: list[tuple] = []
        for alt in self.rules[self.root_id]:
            self.stacks.extend(self._expand(tuple(reversed(alt))))
        self.stacks = self._dedup(self.stacks)

    # stack: tuple of Els, top = last element
    def _expand(self, stack: tuple) -> list[tuple]:
        """Expand until top of stack is a CHAR element (or empty)."""
        if not stack:
            return [stack]
        top = stack[-1]
        if top.type in (ElType.CHAR, ElType.CHAR_NOT):
            return [stack]
        assert top.type == ElType.RULE_REF
        out = []
        for alt in self.rules[top.value[0]]:
            new = stack[:-1] + tuple(reversed(alt))
            out.extend(self._expand(new))
        return out

    @staticmethod
    def _dedup(stacks):
        seen = set()
        out = []
        for s in stacks:
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out

    def accept_char(self, cp: int) -> bool:
        new_stacks = []
        for stack in self.stacks:
            if not stack:
                continue
            top = stack[-1]
            if _char_match(top, cp):
                new_stacks.extend(self._expand(stack[:-1]))
        new_stacks = self._dedup(new_stacks)
        if not new_stacks:
            return False
        self.stacks = new_stacks
        return True

    def copy(self) -> "Grammar":
        g = object.__new__(Grammar)
        g.rules = self.rules
        g.root_id = self.root_id
        g.stacks = list(self.stacks)
        return g

    def allows_text(self, text: str) -> bool:
        g = self.copy()
        for ch in text:
            if not g.accept_char(ord(ch)):
                return False
        return True

    def accept_text(self, text: str) -> bool:
        for ch in text:
            if not self.accept_char(ord(ch)):
                return False
        return True

    @property
    def done(self) -> bool:
        """True if the grammar can terminate here (some stack is empty)."""
        return any(not s for s in self.stacks)


class GrammarSampler:
    """Constrained sampling: rejection-filter candidates through the grammar
    (equivalent to llama.cpp's candidate masking, lazily evaluated)."""

    def __init__(self, grammar: Grammar, tokenizer):
        self.grammar = grammar
        self.tok = tokenizer

    def _allows(self, tok: int) -> "str | None":
        """Decoded piece if the grammar allows this token, else None."""
        if tok == self.tok.eos_id:
            return "" if self.grammar.done else None
        piece = self.tok.decode([int(tok)])
        return piece if piece and self.grammar.allows_text(piece) else None

    def filter_and_pick(self, logits, sampler_params, rng, history=None,
                        state=None) -> int:
        """One sampler-chain run, then a grammar mask over the SURVIVING
        candidate set (renormalize, pick) — the reference's lazy grammar
        sampler (llama_sampler_grammar: sample first; on a reject, apply
        the grammar to the candidate array and resample) instead of a
        rejection loop that reruns the whole chain per banned token."""
        import numpy as np
        from .sampling import sample as sample_token
        logits = np.array(logits, np.float32)

        if sampler_params.temp <= 0.0 and sampler_params.mirostat == 0:
            for _ in range(2048):   # greedy: ban-and-retry is one argmax
                tok = int(np.argmax(logits))
                if logits[tok] == -np.inf:
                    break
                piece = self._allows(tok)
                if piece is not None:
                    if piece:
                        self.grammar.accept_text(piece)
                    return tok
                logits[tok] = -np.inf
            else:
                # past the fast tries: the rest of the vocabulary in logit
                # order (see _whole_vocab_pick)
                for tok in np.argsort(-logits, kind="stable"):
                    if logits[tok] == -np.inf:
                        break
                    piece = self._allows(int(tok))
                    if piece is not None:
                        if piece:
                            self.grammar.accept_text(piece)
                        return int(tok)
            raise RuntimeError("no grammar-conforming token found")

        for _ in range(64):   # rounds of candidate sets (vocab/top_k bound)
            tok, order, probs = sample_token(logits, sampler_params, rng,
                                             history=history, state=state,
                                             return_probs=True)
            piece = self._allows(int(tok))
            if piece is not None:          # fast path: first pick conforms
                if piece:
                    self.grammar.accept_text(piece)
                return int(tok)
            pieces = {int(t): self._allows(int(t)) for t in order}
            ok = [i for i, t in enumerate(order) if pieces[int(t)] is not None]
            if ok:
                pk = probs[ok] / probs[ok].sum()
                tok = int(order[ok[int(rng.choice(len(ok), p=pk))]])
                piece = pieces[tok]
                if piece:
                    self.grammar.accept_text(piece)
                return tok
            # every candidate rejected: ban them and rerun the chain
            logits[np.asarray(order, np.int64)] = -np.inf
            if not np.isfinite(logits).any():
                break
        else:
            return self._whole_vocab_pick(logits, sampler_params, rng, history, state)
        raise RuntimeError("no grammar-conforming token found")

    def _whole_vocab_pick(self, logits, sampler_params, rng, history, state) -> int:
        """Past the bounded retries, the grammar masks every token left (the
        reference applies the grammar to the whole candidate array on a
        reject, common/sampling.cpp) and the chain samples the survivors:
        a conforming token is found whenever one exists, however low its
        logit (on random weights the JSON of a forced call ranks near the
        bottom of 32,000 pieces). The JAX package raises here instead."""
        import numpy as np
        from .sampling import sample as sample_token
        live = np.flatnonzero(np.isfinite(logits))
        ok = [int(t) for t in live if self._allows(int(t)) is not None]
        if not ok:
            raise RuntimeError("no grammar-conforming token found")
        masked = np.full_like(logits, -np.inf)
        masked[ok] = logits[ok]
        tok = int(sample_token(masked, sampler_params, rng, history=history, state=state))
        piece = self._allows(tok)
        if piece:
            self.grammar.accept_text(piece)
        return tok
