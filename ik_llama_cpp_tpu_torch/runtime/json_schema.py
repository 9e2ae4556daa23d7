"""JSON-schema -> GBNF converter — analogue of common/json-schema-to-grammar.cpp.

Supports: object (properties/required/additionalProperties=false), array
(items, minItems/maxItems), string (enum/const/pattern/minLength/maxLength),
number, integer, boolean, null, anyOf/oneOf, $ref (local #/definitions and
#/$defs).  ``regex_to_gbnf`` is the examples/regex_to_grammar.py analogue:
a regex subset (literals, ., classes, groups, alternation, * + ?
{m}/{m,}/{m,n} quantifiers, \\d \\w \\s escapes, trimmed ^ $ anchors)
compiled to GBNF — json-schema-to-grammar.cpp _visit_pattern.
"""
from __future__ import annotations

import json
import re

SPACE = 'space ::= " "?'
PRIMITIVES = {
    "boolean": 'boolean ::= ("true" | "false") space',
    "null": 'null ::= "null" space',
    "number": 'number ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": 'integer ::= ("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": r'''string ::= "\"" (
        [^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])
      )* "\"" space''',
    "value": 'value ::= object | array | string | number | boolean | null',
    "object": r'object ::= "{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": r'array ::= "[" space ( value ("," space value)* )? "]" space',
}


def _lit(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{out}"'


_CLASS_ESC = {"d": "0-9", "D": "^0-9", "w": "0-9A-Za-z_", "W": "^0-9A-Za-z_",
              "s": " \\t\\n\\r", "S": "^ \\t\\n\\r"}


class _RegexParser:
    """Regex-subset -> GBNF expression (json-schema-to-grammar.cpp
    _visit_pattern). Raises ValueError on unsupported constructs."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else ""

    def parse(self) -> str:
        out = self._alternation()
        if self.i != len(self.p):
            raise ValueError(f"regex: unexpected '{self._peek()}' at {self.i}")
        return out

    def _alternation(self) -> str:
        alts = [self._sequence()]
        while self._peek() == "|":
            self.i += 1
            alts.append(self._sequence())
        return " | ".join(a or '""' for a in alts)

    def _sequence(self) -> str:
        parts = []
        while self.i < len(self.p) and self._peek() not in ("|", ")"):
            parts.append(self._quantified())
        return " ".join(parts)

    def _quantified(self) -> str:
        atom = self._atom()
        c = self._peek()
        if c and c in "*+?":
            self.i += 1
            return f"{atom}{c}"
        if c == "{":
            j = self.p.index("}", self.i)
            spec = self.p[self.i + 1: j]
            if not re.fullmatch(r"\d+(,\d*)?", spec):
                raise ValueError(f"regex: bad quantifier {{{spec}}}")
            self.i = j + 1
            return f"{atom}{{{spec}}}"
        return atom

    def _atom(self) -> str:
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i: self.i + 2] == "?:":
                self.i += 2
            elif self._peek() == "?":
                raise ValueError("regex: lookarounds are not supported")
            inner = self._alternation()
            if self._peek() != ")":
                raise ValueError("regex: unbalanced group")
            self.i += 1
            return f"({inner})"
        if c == "[":
            j = self.i + 1
            if self.p[j: j + 1] == "^":
                j += 1
            if self.p[j: j + 1] == "]":
                j += 1
            while j < len(self.p) and self.p[j] != "]":
                j += 2 if self.p[j] == "\\" else 1
            if j >= len(self.p):
                raise ValueError("regex: unterminated class")
            body = self.p[self.i + 1: j]
            self.i = j + 1
            for k, v in _CLASS_ESC.items():
                if not v.startswith("^"):
                    body = body.replace("\\" + k, v)
            # negated escapes (\D \W \S) cannot be expressed inside a GBNF
            # class — fail here rather than at Grammar() parse time
            k = 0
            while k < len(body):
                if body[k] == "\\":
                    if body[k + 1: k + 2] in ("D", "W", "S"):
                        raise ValueError(
                            "regex: \\D/\\W/\\S inside a character class "
                            "is not supported")
                    k += 2
                else:
                    k += 1
            return f"[{body}]"
        if c == ".":
            self.i += 1
            return "[^\\n]"
        if c == "\\":
            e = self.p[self.i + 1: self.i + 2]
            self.i += 2
            if e in _CLASS_ESC:
                cls = _CLASS_ESC[e]
                return f"[{cls}]"
            if e and e in "nrt":
                return f'"\\{e}"'
            return _lit(e)
        if c in ("^", "$"):
            # anchors: a GBNF rule is whole-string anyway, so a leading ^ /
            # trailing $ is a no-op — but an INTERIOR anchor changes the
            # language (e.g. 'a$b' matches nothing) and must not be dropped
            if (c == "^" and self.i != 0) or \
                    (c == "$" and self.i != len(self.p) - 1):
                raise ValueError(
                    f"regex: interior '{c}' anchor is not supported")
            self.i += 1
            return ""
        self.i += 1
        return _lit(c)


def regex_to_gbnf_expr(pattern: str) -> str:
    """Compile a regex to a GBNF expression fragment (no root wrapper)."""
    expr = _RegexParser(pattern).parse()
    # drop empties produced by stripped anchors
    return " ".join(t for t in expr.split(" ") if t) or '""'


def regex_to_gbnf(pattern: str, *, raw: bool = True) -> str:
    """examples/regex_to_grammar.py analogue.  raw=False wraps the match in
    JSON string quotes (the schema {"type": "string", "pattern": ...})."""
    expr = regex_to_gbnf_expr(pattern)
    if raw:
        return f"root ::= {expr}"
    return f'root ::= "\\"" {expr} "\\"" space\nspace ::= " "?'


class SchemaConverter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": SPACE}
        self.used: set[str] = set()

    def _prim(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = PRIMITIVES[name]
            if name in ("value", "object", "array"):
                for dep in ("object", "array", "string", "number", "boolean",
                            "null", "value"):
                    if dep not in self.rules:
                        self.rules[dep] = PRIMITIVES[dep]
        return name

    def _resolve_ref(self, ref: str) -> dict:
        node = self.schema
        for part in ref.lstrip("#/").split("/"):
            node = node[part]
        return node

    def _name(self, base: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", base) or "rule"
        name = base
        i = 0
        while name in self.used:
            i += 1
            name = f"{base}{i}"
        self.used.add(name)
        return name

    def visit(self, schema: dict, name: str) -> str:
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]),
                              name or schema["$ref"].split("/")[-1])
        if "const" in schema:
            rn = self._name(name or "const")
            self.rules[rn] = f"{rn} ::= {_lit(json.dumps(schema['const']))} space"
            return rn
        if "enum" in schema:
            rn = self._name(name or "enum")
            alts = " | ".join(_lit(json.dumps(v)) for v in schema["enum"])
            self.rules[rn] = f"{rn} ::= ({alts}) space"
            return rn
        if "anyOf" in schema or "oneOf" in schema:
            subs = schema.get("anyOf") or schema.get("oneOf")
            rn = self._name(name or "any")
            alts = " | ".join(self.visit(s, f"{rn}-{i}") for i, s in enumerate(subs))
            self.rules[rn] = f"{rn} ::= {alts}"
            return rn
        t = schema.get("type")
        if t == "object" and "properties" in schema:
            rn = self._name(name or "obj")
            props = list(schema["properties"].items())
            required = set(schema.get("required", [p for p, _ in props]))
            parts = ['"{" space']
            first = True
            for pname, pschema in props:
                sub = self.visit(pschema, f"{rn}-{pname}")
                kv = f'{_lit(json.dumps(pname))} ":" space {sub}'
                if pname in required:
                    if not first:
                        parts.append('"," space')
                    parts.append(kv)
                    first = False
                else:
                    sep = '"," space ' if not first else ""
                    parts.append(f"({sep}{kv})?")
                    if first:
                        first = False
            parts.append('"}" space')
            self.rules[rn] = f"{rn} ::= " + " ".join(parts)
            return rn
        if t == "array":
            rn = self._name(name or "arr")
            item = self.visit(schema.get("items", {}), f"{rn}-item")
            mn = int(schema.get("minItems", 0))
            mx = None if schema.get("maxItems") is None \
                else int(schema["maxItems"])
            if mx == 0:
                body = '""'                 # only the empty array
            elif mn == 0 and mx is None:
                body = f'({item} ("," space {item})*)?'
            else:
                # first item + bounded tail repetitions
                tail = f'("," space {item})'
                hi = "" if mx is None else str(mx - 1)
                rep = f"{tail}{{{max(0, mn - 1)},{hi}}}"
                body = f"{item} {rep}" if mn >= 1 else f"({item} {rep})?"
            self.rules[rn] = f'{rn} ::= "[" space {body} "]" space'
            return rn
        if t == "string" and "pattern" in schema:
            rn = self._name(name or "pat")
            expr = regex_to_gbnf_expr(schema["pattern"])
            self.rules[rn] = f'{rn} ::= "\\"" {expr} "\\"" space'
            return rn
        if t == "string" and ("minLength" in schema or "maxLength" in schema):
            rn = self._name(name or "str")
            mn = int(schema.get("minLength", 0))
            mx = schema.get("maxLength")
            hi = "" if mx is None else str(int(mx))
            char = r'([^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4}))'
            self.rules[rn] = \
                f'{rn} ::= "\\"" {char}{{{mn},{hi}}} "\\"" space'
            return rn
        if t in ("string", "number", "integer", "boolean", "null"):
            return self._prim(t)
        return self._prim("value")

    def grammar(self) -> str:
        root = self.visit(self.schema, "root0")
        lines = [f"root ::= {root}"]
        lines.extend(self.rules.values())
        return "\n".join(lines)


def tool_call_gbnf(tools: list, *, open_tag: str = "",
                   close_tag: str = "") -> str:
    """GBNF forcing a single tool call — the backing for the chat API's
    ``tool_choice: "required"`` / named-function choice (the reference
    builds per-format lazy grammars in common/chat.cpp; here the call JSON
    is schema-constrained and wrapped in the template's call markers).

    tools: OpenAI tool definitions [{"type": "function", "function":
    {"name", "parameters"}}]. The call body is
    ``{"name": <const>, "arguments": <parameters schema>}``.
    """
    alts = []
    for t in tools:
        fn = t.get("function", t)
        alts.append({
            "type": "object",
            "properties": {
                "name": {"const": fn.get("name", "")},
                "arguments": fn.get("parameters") or {"type": "object"},
            },
            "required": ["name", "arguments"],
        })
    schema = {"anyOf": alts} if len(alts) != 1 else alts[0]
    conv = SchemaConverter(schema)
    call = conv.visit(schema, "toolcall")
    parts = ([_lit(open_tag)] if open_tag else []) + ["space", call] + \
        ([_lit(close_tag)] if close_tag else [])
    lines = [f"root ::= {' '.join(parts)} space"]
    lines.extend(conv.rules.values())
    return "\n".join(lines)


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return SchemaConverter(schema).grammar()


def pydantic_models_to_gbnf(*models) -> str:
    """examples/pydantic_models_to_grammar.py analogue: constrain output to
    any of the given pydantic models' JSON shapes (anyOf over their
    model_json_schema(), $defs resolved by the converter)."""
    schemas = [m.model_json_schema() for m in models]
    if len(schemas) == 1:
        return json_schema_to_gbnf(schemas[0])
    merged_defs = {}
    for s in schemas:
        merged_defs.update(s.pop("$defs", {}))
    return json_schema_to_gbnf(
        {"anyOf": schemas, "$defs": merged_defs})
