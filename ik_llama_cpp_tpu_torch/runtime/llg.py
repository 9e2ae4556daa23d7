"""Pluggable constrained-decoding backends — the analogue of the reference's
optional llguidance integration (common/llguidance.cpp).

The reference ships an adapter sampler that asks an external engine
(llguidance) for a per-step token mask, keyed by a (grammar_kind,
grammar_data) pair where kind is one of "gbnf", "regex", "json" (a JSON
schema) or "lark" (llguidance's native grammar syntax). This module is the
same uniform entry point for this engine:

  * ``constraint_from(kind, data, tokenizer)`` returns a GrammarSampler
    regardless of kind — "regex"/"json" compile through the existing
    converters (runtime/json_schema.py), "lark" through the translator
    below, "gbnf" passes through.
  * If a real ``llguidance`` python package is importable (it is optional
    in the reference too — LLAMA_USE_LLGUIDANCE), ``constraint_from``
    delegates to it via ``LLGuidanceSampler`` instead; otherwise the
    built-in incremental GBNF engine (runtime/grammar.py) serves every
    kind. Register additional engines with ``register_backend``.

Lark subset supported by the translator (the constructs llguidance's docs
use for constrained decoding): rule/terminal definitions, ``|``
alternatives, ``(...)`` groups, ``[...]`` optionals, ``?``/``*``/``+``
postfix, string literals, ``/.../`` regex terminals and character classes.
``%ignore`` and lexer priorities are lexer-level concepts with no GBNF
equivalent and raise a clear error.

The torch port's copy of the JAX package's ``runtime/llg.py``: numpy and the
standard library only, held to the JAX module by
``tests/test_torch_server_extras.py``.
"""
from __future__ import annotations

import re

from .grammar import Grammar, GrammarSampler
from .json_schema import json_schema_to_gbnf, regex_to_gbnf_expr


class LarkTranslateError(ValueError):
    pass


def _gbnf_name(name: str) -> str:
    """Lark names (incl. UPPERCASE terminals) -> GBNF rule names."""
    out = name.lower().replace("_", "-")
    if out == "start":
        return "root"
    # avoid colliding with a lark rule literally named "root"
    return "lk-root" if out == "root" else out


class _LarkParser:
    """Recursive-descent parser over one lark expansion string."""

    def __init__(self, text: str, names: set):
        self.text = text
        self.pos = 0
        self.names = names

    def _ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def peek(self):
        self._ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def parse_alternatives(self) -> str:
        parts = [self.parse_sequence()]
        while self.peek() == "|":
            self.pos += 1
            parts.append(self.parse_sequence())
        return " | ".join(parts)

    def parse_sequence(self) -> str:
        items = []
        while True:
            c = self.peek()
            if c in ("", "|", ")", "]"):
                break
            items.append(self.parse_item())
        return " ".join(items) if items else "\"\""

    def parse_item(self) -> str:
        atom = self.parse_atom()
        c = self.peek()
        if c in ("?", "*", "+"):
            self.pos += 1
            return f"{atom}{c}"
        if c == "~":
            raise LarkTranslateError(
                "lark '~ n..m' repetition ranges are not supported; "
                "expand them explicitly")
        return atom

    def parse_atom(self) -> str:
        c = self.peek()
        t = self.text
        if c == "(":
            self.pos += 1
            inner = self.parse_alternatives()
            if self.peek() != ")":
                raise LarkTranslateError(f"unbalanced ( at {self.pos}")
            self.pos += 1
            return f"({inner})"
        if c == "[":
            self.pos += 1
            inner = self.parse_alternatives()
            if self.peek() != "]":
                raise LarkTranslateError(f"unbalanced [ at {self.pos}")
            self.pos += 1
            return f"({inner})?"       # lark [...] = optional
        if c == '"':
            end = self.pos + 1
            while end < len(t) and (t[end] != '"' or t[end - 1] == "\\"):
                end += 1
            if end >= len(t):
                raise LarkTranslateError("unterminated string literal")
            lit = t[self.pos:end + 1]
            self.pos = end + 1
            if self.peek() == "i" and lit != '"':   # case-insensitive flag
                raise LarkTranslateError(
                    "case-insensitive literals (\"...\"i) are not supported")
            return lit                  # GBNF string literals are identical
        if c == "/":
            end = self.pos + 1
            while end < len(t) and (t[end] != "/" or t[end - 1] == "\\"):
                end += 1
            if end >= len(t):
                raise LarkTranslateError("unterminated /regex/ terminal")
            pattern = t[self.pos + 1:end]
            self.pos = end + 1
            return f"({regex_to_gbnf_expr(pattern)})"
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", t[self.pos:])
        if not m:
            raise LarkTranslateError(
                f"unexpected character {c!r} at {self.pos} in {t!r}")
        self.pos += m.end()
        name = m.group(0)
        if name not in self.names:
            raise LarkTranslateError(f"undefined rule/terminal {name!r}")
        return _gbnf_name(name)


def lark_to_gbnf(text: str) -> str:
    """Translate a lark grammar (llguidance's native syntax) to GBNF."""
    # strip comments; join continuation lines (expansions indented under a
    # rule or starting with |)
    lines: list[str] = []
    for raw in text.splitlines():
        line = re.sub(r"//.*$", "", raw).rstrip()
        if not line.strip():
            continue
        if line.strip().startswith("%"):
            d = line.strip().split()[0]
            raise LarkTranslateError(
                f"lark directive {d!r} is lexer-level and has no GBNF "
                "equivalent (the built-in engine is scannerless); inline "
                "whitespace/ignore handling into the rules")
        if (line[0].isspace() or line.lstrip().startswith("|")) and lines:
            lines[-1] += " " + line.strip()
        else:
            lines.append(line.strip())

    rules: list[tuple[str, str]] = []
    for line in lines:
        m = re.match(r"([?!]?)([A-Za-z_][A-Za-z0-9_]*)(\.\d+)?\s*:\s*(.*)$",
                     line)
        if not m:
            raise LarkTranslateError(f"cannot parse lark rule line: {line!r}")
        rules.append((m.group(2), m.group(4)))
    if not rules:
        raise LarkTranslateError("empty lark grammar")
    names = {n for n, _ in rules}
    if "start" not in names:
        raise LarkTranslateError("lark grammar needs a 'start' rule")

    out = []
    for name, expansion in rules:
        p = _LarkParser(expansion, names)
        body = p.parse_alternatives()
        if p.peek():
            raise LarkTranslateError(
                f"trailing input {p.text[p.pos:]!r} in rule {name!r}")
        out.append(f"{_gbnf_name(name)} ::= {body}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

def to_gbnf(kind: str, data: str) -> str:
    """(grammar_kind, grammar_data) -> GBNF text for the built-in engine."""
    if kind in ("gbnf", "grammar"):
        return data
    if kind in ("json", "json_schema"):
        return json_schema_to_gbnf(data)
    if kind == "regex":
        return f"root ::= {regex_to_gbnf_expr(data)}\n"
    if kind == "lark":
        return lark_to_gbnf(data)
    raise ValueError(f"unknown grammar kind {kind!r} "
                     "(expected gbnf/json/regex/lark)")


def _builtin_backend(kind: str, data: str, tokenizer):
    return GrammarSampler(Grammar(to_gbnf(kind, data)), tokenizer)


class LLGuidanceSampler:
    """Adapter over the real llguidance python package (optional, like the
    reference's LLAMA_USE_LLGUIDANCE build): per-step token bitmask from
    llg_compute_mask, commit on accept — drop-in for GrammarSampler."""

    def __init__(self, llg, kind: str, data: str, tokenizer):
        self.tok = tokenizer
        self._interp = llg.LLInterpreter(
            llg.LLTokenizer(tokenizer), grammar_kind=kind, grammar_data=data)

    def filter_and_pick(self, logits, sampler_params, rng, history=None,
                        state=None) -> int:
        import numpy as np
        from .sampling import sample as sample_token
        logits = np.array(logits, np.float32)
        mask = np.frombuffer(self._interp.compute_mask(), np.uint8)
        bits = np.unpackbits(mask, bitorder="little")[:logits.shape[0]]
        logits[bits == 0] = -np.inf
        tok = int(sample_token(logits, sampler_params, rng, history=history,
                               state=state))
        self._interp.commit_token(tok)
        return tok


_BACKENDS: dict = {}


def register_backend(name: str, factory) -> None:
    """factory(kind, data, tokenizer) -> sampler with filter_and_pick()."""
    _BACKENDS[name] = factory


def constraint_from(kind: str, data: str, tokenizer, backend: str = "auto"):
    """Uniform entry point: (grammar_kind, grammar_data) -> sampler.

    backend: "auto" prefers a registered/importable llguidance engine and
    falls back to the built-in GBNF engine; "builtin"/"llguidance" force.
    """
    if backend in _BACKENDS:
        return _BACKENDS[backend](kind, data, tokenizer)
    if backend in ("auto", "llguidance"):
        try:
            import llguidance  # optional: neither machine has it
            return LLGuidanceSampler(llguidance, kind, data, tokenizer)
        except ImportError:
            if backend == "llguidance":
                raise
    return _builtin_backend(kind, data, tokenizer)
