"""Chat template auto-parser: differential template analysis + streaming
output parser — the analogue of the reference's
chat-auto-parser (common/chat-auto-parser-generator.cpp,
chat-diff-analyzer.cpp) and its PEG streaming parsers
(chat-peg-parser.cpp).

Instead of hand-writing one parser per model family, the jinja chat
template itself is ANALYZED by rendering controlled message variants and
diffing the outputs:

  * reasoning markers from an assistant turn rendered with two different
    ``reasoning_content`` payloads (common prefix/suffix around the
    divergence = the opening/closing tags, e.g. <think>...</think>); the
    generation-prompt tail is checked for a forced-open reasoning block
    (templates that end the prompt inside <think>).
  * the per-call tool syntax from name-pair and argument-pair renders:
    the divergence bounds give the exact name and argument positions
    inside one rendered call, and the surrounding literal text is
    compiled into a parse REGEX (the analogue of the reference's
    generated PEG grammar). Both JSON-argument calls
    (<tool_call>{...}</tool_call>, [TOOL_CALLS]name[ARGS]{...},
    <|tool_call_begin|>functions.name:0<|tool_call_argument_begin|>{...})
    and key/value-tag calls (<arg_key>k</arg_key><arg_value>v</arg_value>,
    <parameter=k>v</parameter>) are synthesized from the same probes.

TemplateAnalysis drives batch parsing (parse_auto) and the incremental
StreamParser used by the streaming chat endpoint: deltas are classified
into reasoning / content / tool-call events with marker holdback so a
marker split across deltas is never mis-emitted as content.

The torch port's copy of the JAX package's ``runtime/chat_autoparser.py``: numpy and the
standard library only, held to the JAX module by
``tests/test_torch_server_extras.py``.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from .chat import ToolCall

_CONT_A = "ZCNTAZ"
_REAS_A = "ZRSNAZ"
_REAS_B = "ZRSNBZ"
_NAME_A = "zfuncaz"
_NAME_B = "zfuncbz"
_ARG_K = "zargkey"
_ARG_VA = "zargvalz"
_ARG_VB = "zvalotherz"
_CALL_ID = "zcallidz"


def _render(src: str, messages, *, tools=None, add_gen=False, think=True):
    import jinja2
    env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True,
                             extensions=["jinja2.ext.loopcontrols"])
    env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
    env.globals["raise_exception"] = lambda m: ""
    env.globals["strftime_now"] = lambda fmt: ""
    return env.from_string(src).render(
        messages=[dict(m) for m in messages],
        add_generation_prompt=add_gen, bos_token="", eos_token="",
        tools=tools, enable_thinking=think, thinking=think)


def _common_prefix_len(a: str, b: str) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _common_suffix_len(a: str, b: str) -> int:
    n = 0
    for x, y in zip(reversed(a), reversed(b)):
        if x != y:
            break
        n += 1
    return n


_TAG_TAIL = re.compile(r"(<[^<>\n]{1,64}>\s*|\[[A-Z_]{2,32}\]\s*)$")
_TAG_HEAD = re.compile(r"^(\s*<[^<>\n]{1,64}>|\s*\[[A-Z_]{2,32}\])")
_LEAD_TAG = re.compile(r"(<[^<>\n]{1,64}>|\[[A-Z_]{2,32}\])")


@dataclass
class TemplateAnalysis:
    reasoning_open: str = ""
    reasoning_close: str = ""
    reasoning_forced_open: bool = False
    tool_format: str = "none"     # none | bare_json | generic
    call_regex: str = ""          # generic: groups name=1 (+args=2 for json)
    args_mode: str = "json"       # json | kv
    # kv mode: per-pair markers inside the call body
    kv_regex: str = ""            # groups key=1, value=2
    args_span_regex: str = ""     # captures the kv args body within a call
    call_lead: str = ""           # earliest literal marker opening a call
    call_trail: str = ""          # literal marker closing a call ("" = \n/eos)

    def has_tools(self) -> bool:
        return self.tool_format != "none"


def _probe_calls(src, user, as_dict):
    def call(name, args, cid=_CALL_ID):
        return {"id": cid, "type": "function",
                "function": {"name": name,
                             "arguments": args if as_dict
                             else json.dumps(args)}}
    tools = [{"type": "function",
              "function": {"name": n, "description": "d",
                           "parameters": {"type": "object", "properties": {
                               _ARG_K: {"type": "string"}}}}}
             for n in (_NAME_A, _NAME_B)]
    mk = lambda calls: {"role": "assistant", "content": "",
                        "tool_calls": calls}
    t0 = _render(src, [user, {"role": "assistant", "content": _CONT_A}],
                 tools=tools)
    ta = _render(src, [user, mk([call(_NAME_A, {_ARG_K: _ARG_VA})])],
                 tools=tools)
    tb = _render(src, [user, mk([call(_NAME_B, {_ARG_K: _ARG_VA})])],
                 tools=tools)
    tv = _render(src, [user, mk([call(_NAME_A, {_ARG_K: _ARG_VB})])],
                 tools=tools)
    t2 = _render(src, [user, mk([call(_NAME_A, {_ARG_K: _ARG_VA}),
                                 call(_NAME_B, {_ARG_K: _ARG_VA}, "zzid2")])],
                 tools=tools)
    return t0, ta, tb, tv, t2


def analyze_template(src: str) -> TemplateAnalysis:
    """Differential analysis of a jinja chat template."""
    out = TemplateAnalysis()
    user = {"role": "user", "content": "hi"}

    # ---- reasoning markers --------------------------------------------
    try:
        ra = _render(src, [user, {"role": "assistant", "content": _CONT_A,
                                  "reasoning_content": _REAS_A}])
        rb = _render(src, [user, {"role": "assistant", "content": _CONT_A,
                                  "reasoning_content": _REAS_B}])
    except Exception:
        ra = rb = ""
    if _REAS_A in ra and _REAS_B in rb:
        pre = ra[:_common_prefix_len(ra, rb)]
        suf = ra[len(ra) - _common_suffix_len(ra, rb):]
        m = _TAG_TAIL.search(pre)
        out.reasoning_open = m.group(1).strip() if m else ""
        m = _TAG_HEAD.match(suf)
        out.reasoning_close = m.group(1).strip() if m else ""
    if not out.reasoning_open and "<think>" in src:
        out.reasoning_open, out.reasoning_close = "<think>", "</think>"
    if out.reasoning_open:
        try:
            gen = _render(src, [user], add_gen=True)
            out.reasoning_forced_open = gen.rstrip().endswith(
                out.reasoning_open)
        except Exception:
            pass

    # ---- tool-call syntax ---------------------------------------------
    probes = None
    # prefer dict-form arguments: templates that |tojson them render the
    # plain JSON object the MODEL actually emits (string-form arguments
    # get double-escaped in some templates, e.g. mistral [ARGS])
    for as_dict in (True, False):
        try:
            probes = _probe_calls(src, user, as_dict)
            if _NAME_A in probes[1] and _ARG_VA in probes[1] and \
                    probes[1] != probes[2]:
                break
            probes = None
        except Exception:
            probes = None
    if probes is None:
        return out
    t0, ta, tb, tv, t2 = probes

    n0 = _common_prefix_len(ta, tb)                 # name start
    n1 = len(ta) - _common_suffix_len(ta, tb)       # name end
    v0 = _common_prefix_len(ta, tv)                 # args-value start
    v1 = len(ta) - _common_suffix_len(ta, tv)       # args-value end
    c0 = _common_prefix_len(ta, t0)                 # call region start
    c1 = len(ta) - _common_suffix_len(ta, t0)       # call region end
    c0 = min(c0, n0)
    c1 = max(c1, v1)
    body = ta[c0:c1]

    def wild(e):
        """escaped body -> parse regex (name, id, args wildcards)."""
        first = True
        while re.escape(_NAME_A) in e:
            e = e.replace(re.escape(_NAME_A),
                          r"([\w.\-]+)" if first else r"\1", 1)
            first = False
        e = e.replace(re.escape(_CALL_ID), r"[^\s<>\[\]]*")
        return e

    arg_json = json.dumps({_ARG_K: _ARG_VA})
    arg_json_q = json.dumps(arg_json)
    if arg_json in body or arg_json_q in body:
        out.args_mode = "json"
        lit = arg_json if arg_json in body else arg_json_q
        e = re.escape(body).replace(
            re.escape(lit),
            r"(\{.*?\})" if lit is arg_json else r"(\"\{.*?\}\")", 1)
        out.call_regex = wild(e)
        out.tool_format = "generic"
    elif _ARG_K in body and _ARG_VA in body:
        out.args_mode = "kv"
        k0 = body.index(_ARG_K)
        kv0 = body.index(_ARG_VA)
        kv_body = body[k0 - 64 if k0 > 64 else 0:]
        # pair markers: tag-ish chunk before the key, the key->value
        # transition, and the value-closing chunk
        pre_k = body[:k0]
        m = re.search(r"([<\[][^<>\[\]\n]{0,48}[=>\]]\s*|[<\[][^<>\[\]\n]"
                      r"{0,48}=)$", pre_k)
        key_open = m.group(0) if m else pre_k.rsplit(None, 1)[-1]
        key_close = body[k0 + len(_ARG_K):kv0]
        after_v = body[kv0 + len(_ARG_VA):]
        m = _LEAD_TAG.search(after_v)
        val_close = after_v[:m.end()] if m else ""
        out.kv_regex = (re.escape(key_open) + r"([\w.\-]+)" +
                        re.escape(key_close).replace(r"\ ", r"\s*") +
                        r"(.*?)" + re.escape(val_close))
        # whole-call regex: args span = from first pair to value close
        pair = body[k0 - len(key_open):kv0 + len(_ARG_VA) + len(val_close)]
        e = re.escape(body).replace(re.escape(pair), r"((?:.|\n)*?)", 1)
        out.call_regex = wild(e)
        out.tool_format = "generic"
        del kv_body
    else:
        # bare JSON object/array containing the name
        out.tool_format = "bare_json"
        return out

    # flexible whitespace + trailing-context trim: cut the regex after the
    # last literal marker following the args
    out.call_regex = out.call_regex.replace(r"\n", r"\s*")
    m = _LEAD_TAG.search(ta[v1:c1] if v1 < c1 else "")
    out.call_trail = m.group(0) if m else ""
    m = _LEAD_TAG.search(body)
    out.call_lead = m.group(0) if m and m.start() <= max(0, n0 - c0) else \
        (body[:n0 - c0].strip().split()[-1] if body[:n0 - c0].strip()
         else "")
    return out


# ---------------------------------------------------------------------------


def _mk_call(name: str, args) -> ToolCall:
    if isinstance(args, str):
        s = args.strip()
        try:
            obj = json.loads(s)
            if isinstance(obj, str):      # double-encoded (mistral [ARGS])
                obj = json.loads(obj)
            args = json.dumps(obj)
        except json.JSONDecodeError:
            args = json.dumps({"raw": s})
    else:
        args = json.dumps(args)
    return ToolCall(name=name, arguments=args)


def parse_auto(text: str, an: TemplateAnalysis):
    """(reasoning, content, calls) from a completed generation."""
    reasoning = ""
    if an.reasoning_open:
        op, cl = re.escape(an.reasoning_open), re.escape(an.reasoning_close)
        m = re.search(op + r"(.*?)" + cl, text, re.DOTALL)
        if m:
            reasoning = m.group(1).strip()
            text = text[:m.start()] + text[m.end():]
        elif an.reasoning_forced_open and an.reasoning_close in text:
            head, _, text = text.partition(an.reasoning_close)
            reasoning = head.strip()

    calls: list[ToolCall] = []
    if an.tool_format == "generic" and an.call_regex:
        pat = re.compile(an.call_regex, re.DOTALL)

        def sub(m):
            name = m.group(1)
            if name.startswith("functions."):
                name = name.split("functions.", 1)[1].rsplit(":", 1)[0] \
                    if ":" in name else name[len("functions."):]
            if an.args_mode == "json":
                calls.append(_mk_call(name, m.group(2)))
            else:
                kvs = re.findall(an.kv_regex, m.group(2) or "", re.DOTALL)
                args = {}
                for k, v in kvs:
                    v = v.strip()
                    try:
                        args[k] = json.loads(v)
                    except json.JSONDecodeError:
                        args[k] = v
                calls.append(ToolCall(name=name,
                                      arguments=json.dumps(args)))
            return ""
        text = pat.sub(sub, text)
    elif an.tool_format == "bare_json":
        stripped = text.strip()
        try:
            obj = json.loads(stripped)
            objs = obj if isinstance(obj, list) else [obj]
            got = [o for o in objs if isinstance(o, dict) and "name" in o]
            if got and len(got) == len(objs):
                for o in got:
                    calls.append(_mk_call(
                        o["name"], o.get("arguments", o.get("parameters",
                                                            {}))))
                text = ""
        except json.JSONDecodeError:
            pass
    return reasoning, text.strip(), calls


class StreamParser:
    """Incremental classifier for streamed generation text.

    ``feed(delta)`` yields ("reasoning"|"content", text) and
    ("tool_call", ToolCall) events. Markers split across deltas are held
    back (longest-marker buffering) — the streaming analogue of the
    reference's PEG partial-parse states (chat-peg-parser.cpp)."""

    def __init__(self, an: TemplateAnalysis):
        self.an = an
        self.buf = ""
        self.state = "reasoning" if an.reasoning_forced_open else "content"
        markers = [an.reasoning_open, an.reasoning_close, an.call_lead,
                   an.call_trail]
        self._hold = max((len(m) for m in markers if m), default=0) + 16
        self._call_pat = (re.compile(an.call_regex, re.DOTALL)
                          if an.call_regex else None)

    def feed(self, delta: str):
        an = self.an
        self.buf += delta
        out = []
        while True:
            if self.state == "reasoning":
                idx = self.buf.find(an.reasoning_close) \
                    if an.reasoning_close else -1
                if idx >= 0:
                    if self.buf[:idx]:
                        out.append(("reasoning", self.buf[:idx]))
                    self.buf = self.buf[idx + len(an.reasoning_close):]
                    self.state = "content"
                    continue
                safe = max(0, len(self.buf) - self._hold)
                if safe:
                    out.append(("reasoning", self.buf[:safe]))
                    self.buf = self.buf[safe:]
                return out
            if self.state == "content":
                starts = []
                if an.reasoning_open:
                    i = self.buf.find(an.reasoning_open)
                    if i >= 0:
                        starts.append((i, "reasoning"))
                if an.call_lead:
                    i = self.buf.find(an.call_lead)
                    if i >= 0:
                        starts.append((i, "tool"))
                if starts:
                    starts.sort()
                    i, kind = starts[0]
                    if self.buf[:i]:
                        out.append(("content", self.buf[:i]))
                    if kind == "reasoning":
                        self.buf = self.buf[i + len(an.reasoning_open):]
                        self.state = "reasoning"
                    else:
                        self.buf = self.buf[i:]
                        self.state = "tool"
                    continue
                safe = max(0, len(self.buf) - self._hold)
                if safe:
                    out.append(("content", self.buf[:safe]))
                    self.buf = self.buf[safe:]
                return out
            # tool state: wait for a complete call
            if self._call_pat:
                m = self._call_pat.search(self.buf)
                if m:
                    _, _, calls = parse_auto(self.buf[:m.end()], self.an)
                    out.extend(("tool_call", c) for c in calls)
                    self.buf = self.buf[m.end():].lstrip()
                    self.state = "content"
                    continue
            return out
        return out

    def finish(self):
        out = []
        if self.buf:
            r, c, calls = parse_auto(self.buf, self.an)
            if r:
                out.append(("reasoning", r))
            out.extend(("tool_call", cc) for cc in calls)
            if c:
                out.append(("content", c))
        self.buf = ""
        return out
