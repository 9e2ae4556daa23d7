"""The server extras' host modules of the port held to the JAX package's on
the same inputs, exactly: the unicode-script allowlist, the expiring logit
bias state machine, ``llg.to_gbnf``, the chat template's analysis and
``parse_auto``, and the sqlite session store. Every comparison is
equality (bias arrays bit for bit, grammar text and parses as strings)."""
import dataclasses
import json

import numpy as np
import pytest

from ik_llama_cpp_tpu.runtime import allowlist as jallow
from ik_llama_cpp_tpu.runtime import chat_autoparser as jauto
from ik_llama_cpp_tpu.runtime import expiring_bias as jelb
from ik_llama_cpp_tpu.runtime import llg as jllg
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server import sessions as jsessions
from ik_llama_cpp_tpu_torch.runtime import allowlist as tallow
from ik_llama_cpp_tpu_torch.runtime import chat_autoparser as tauto
from ik_llama_cpp_tpu_torch.runtime import expiring_bias as telb
from ik_llama_cpp_tpu_torch.runtime import llg as tllg
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server import sessions as tsessions


class _Tok:
    """One piece an id; ``encode`` picks each piece found in the text."""

    def __init__(self, pieces):
        self.tokens = list(pieces)

    def decode_bytes(self, ids):
        return b"".join(self.tokens[i].encode("utf-8") for i in ids)

    def encode(self, text, add_bos=False):
        return [i for i, p in enumerate(self.tokens) if p and p in text]


PIECES = ["abc", "中文", "a中", " ", "a1", "", "érable", "こんにちは", "αβγ", "Привет",
          "\n", "STOP", "GO"] + [chr(c) for c in range(97, 123)]


@pytest.mark.parametrize("rules", [
    ["latin"], ["latin:0.5", "han:-1"], ["0..127", "hiragana:2"], ["ascii:1", "greek"],
    ["65..90,latin:1.5", "cyrillic:0.25"]])
def test_allowlist_matches_jax(rules):
    """Rule parsing, the bias arrays of every ruleset, pieces and keyword
    expiry over a run of generated text."""
    tok = _Tok(PIECES)
    assert [tallow.parse_rule(r) for r in rules] == [jallow.parse_rule(r) for r in rules]
    sets = [[tallow.parse_rule(r) for r in rules], [tallow.parse_rule("0..1114111")]]
    kw = dict(pieces=["中文"], kw_delay=1)
    j = jallow.build_allowlist(tok, sets, ["STOP"], **kw)
    t = tallow.build_allowlist(tok, sets, ["STOP"], **kw)
    text = ""
    for i, piece in enumerate(["abc", " ", "STO", "P", "a1", "GO"]):
        jb, tb = j.active_bias(), t.active_bias()
        assert (jb is None) == (tb is None)
        if jb is not None:
            np.testing.assert_array_equal(tb, jb)
        prev, text = len(text), text + piece
        j.update(text, prev, i + 1)
        t.update(text, prev, i + 1)
        assert t.idx == j.idx


ELB_RULES = ['(5 : "cat" : 1.0, 2.0)\n"GO"\n(9 : "b" : 2.0)\n',
             '(9 : "a" : 1.0)\n"X"\n(9 : "b" : 1.0)\n"J" >>\n(9 : "c" : 5.0)\n',
             '(2 : temp ~0.5, top_k ~10)\n((3 : "d" : -1.5~1.5))\n"Q"\n(())\n',
             '(-1 : "ab" : 0.5)\n# a comment\n(4 : "x" "y" : 3.0)\n']


@pytest.mark.parametrize("rule", ELB_RULES, ids=["exitword", "jumpword", "params", "forever"])
def test_expiring_bias_matches_jax(rule):
    """The parsed rules, the states, and a run of apply / accept: biased
    logits and sampler parameters at every step."""
    tok = _Tok([chr(i) for i in range(128)])
    tok.encode = lambda text, add_bos=False: [ord(c) for c in text if ord(c) < 128]
    jp, tp = JParams(temp=0.8, top_k=40), SamplerParams(temp=0.8, top_k=40)
    j, t = jelb.build_elb_runtime(tok, rule, jp), telb.build_elb_runtime(tok, rule, tp)
    assert repr(telb.parse_elb(rule)) == repr(jelb.parse_elb(rule)).replace(
        "ik_llama_cpp_tpu.", "ik_llama_cpp_tpu_torch.")
    text = ""
    for piece in ["c", "a", "G", "O", "x", "J", "d", "Q", "b", "c"]:
        jl, tl = np.zeros(128, np.float32), np.zeros(128, np.float32)
        j.apply(jl, text)
        t.apply(tl, text)
        np.testing.assert_array_equal(tl, jl)
        assert (tp.temp, tp.top_k) == (jp.temp, jp.top_k)
        j.accept(text, piece)
        t.accept(text, piece)
        assert t.idx == j.idx
        text += piece


@pytest.mark.parametrize("kind,data", [
    ("regex", "a+"), ("regex", "[0-9]{2,4}-(x|y)?"), ("regex", "\\d+\\.\\d*"),
    ("json", '{"type": "object", "properties": {"a": {"type": "integer"}}}'),
    ("json", '{"type": "array", "items": {"type": "string"}, "maxItems": 3}'),
    ("lark", 'start: "yes" | "no"\n'),
    ("lark", 'start: item+\nitem: WORD " "?\nWORD: /[a-z]+/\n'),
    ("lark", 'start: "a" ["b"] "c"*\n'), ("gbnf", "root ::= [a-z]+")])
def test_llg_to_gbnf_matches_jax(kind, data):
    assert tllg.to_gbnf(kind, data) == jllg.to_gbnf(kind, data)


def test_llg_refusals_match_jax():
    for kind, data in (("lark", 'start: "a"\n%ignore /\\s+/\n'), ("lark", 'value: "a"\n'),
                       ("nope", "x")):
        with pytest.raises(ValueError) as je:
            jllg.to_gbnf(kind, data)
        with pytest.raises(ValueError) as te:
            tllg.to_gbnf(kind, data)
        assert str(te.value) == str(je.value)


# a chatml template with reasoning and JSON tool calls (the Qwen3 form), a
# forced-open one (test_chat_autoparser.py's), and a key/value-tag one
QWEN_LIKE = (
    "{%- if tools %}<|im_start|>system\n<tools>{% for t in tools %}\n{{ t | tojson }}"
    "{% endfor %}\n</tools><|im_end|>\n{% endif %}"
    "{%- for m in messages %}{% if m.role == 'assistant' %}<|im_start|>assistant\n"
    "{% if m.reasoning_content %}<think>\n{{ m.reasoning_content }}\n</think>\n\n{% endif %}"
    "{{ m.content or '' }}{% if m.tool_calls %}{% for tc in m.tool_calls %}\n<tool_call>\n"
    "{\"name\": \"{{ tc.function.name }}\", \"arguments\": {{ tc.function.arguments | tojson }}}"
    "\n</tool_call>{% endfor %}{% endif %}<|im_end|>\n"
    "{% else %}<|im_start|>{{ m.role }}\n{{ m.content }}<|im_end|>\n{% endif %}{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
FORCED_OPEN = (
    "{% for m in messages %}<|im_start|>{{ m.role }}\n{{ m.content }}"
    "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}"
    "<|im_start|>assistant\n<think>{% endif %}")
KV_TAGS = (
    "{% for m in messages %}[{{ m.role }}]{{ m.content or '' }}"
    "{% if m.tool_calls %}{% for tc in m.tool_calls %}<tool_call>{{ tc.function.name }}"
    "{% for k, v in (tc.function.arguments | fromjson if tc.function.arguments is string "
    "else tc.function.arguments).items() %}<arg_key>{{ k }}</arg_key><arg_value>{{ v }}"
    "</arg_value>{% endfor %}</tool_call>{% endfor %}{% endif %}\n{% endfor %}"
    "{% if add_generation_prompt %}[assistant]{% endif %}")
SAMPLES = [
    '<think>Let me see.</think>Sure!\n<tool_call>\n'
    '{"name": "get_weather", "arguments": {"city": "Paris"}}\n</tool_call>',
    '<tool_call>\n{"name": "a", "arguments": {"x": 1}}\n</tool_call>\n<tool_call>\n'
    '{"name": "b", "arguments": {"y": 2}}\n</tool_call>',
    'step one</think>the answer', 'plain text, no call',
    'Done.<tool_call>get_weather<arg_key>city</arg_key><arg_value>Paris</arg_value></tool_call>']


@pytest.mark.parametrize("src", [QWEN_LIKE, FORCED_OPEN, KV_TAGS],
                         ids=["qwen-like", "forced-open", "kv-tags"])
def test_chat_autoparser_matches_jax(src):
    """The template's analysis field by field, and parse_auto on each
    sample (calls as name and parsed arguments)."""
    pytest.importorskip("jinja2")
    ja, ta = jauto.analyze_template(src), tauto.analyze_template(src)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    for text in SAMPLES:
        jr, jc, jcalls = jauto.parse_auto(text, ja)
        tr, tc, tcalls = tauto.parse_auto(text, ta)
        assert (tr, tc) == (jr, jc)
        assert [(c.name, json.loads(c.arguments)) for c in tcalls] == \
            [(c.name, json.loads(c.arguments)) for c in jcalls]
    if src is FORCED_OPEN:
        assert ta.reasoning_forced_open


def test_sessions_match_jax(tmp_path):
    """The same operations on both stores give the same answers."""
    dbs = [jsessions.SessionDB(str(tmp_path / "j.db")),
           tsessions.SessionDB(str(tmp_path / "t.db"))]
    out = []
    for db in dbs:
        got = []
        db.save("sessions", "k1", {"messages": [1, 2]})
        db.save("names", "k1", "first")
        db.save("Odd Store!1", ["k", 2], [3])
        got += [db.load("sessions", "k1"), db.load("names", "k1"), db.load("oddstore", ["k", 2]),
                db.load("sessions", "missing"), db.sessions(), db.all("sessions")]
        db.rename("k1", "renamed")
        db.delete("sessions", "k1")
        db.vacuum()
        got += [db.sessions(), db.all("sessions"), db.all(None),
                tsessions.normalize_store_name(7), tsessions.normalize_store_name("a-B c")]
        db.close()
        out.append(got)
    assert out[1] == out[0]
    assert [jsessions.normalize_store_name(x) for x in (7, "a-B c", "", "Zz")] == \
        [tsessions.normalize_store_name(x) for x in (7, "a-B c", "", "Zz")]
