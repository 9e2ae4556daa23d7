"""The port's grammar, JSON-schema and chat modules against the JAX
package's: the same GBNF text accepts and rejects the same strings, the
same schemas give the same GBNF, grammar-constrained sampling picks the same
tokens, and every chat template renders the same prompt string."""
import json

import numpy as np
import pytest

from fixtures import byte_vocab
from ik_llama_cpp_tpu.runtime import chat as JC
from ik_llama_cpp_tpu.runtime import grammar as JG
from ik_llama_cpp_tpu.runtime import json_schema as JJ
from ik_llama_cpp_tpu.runtime import sampling as JS
from ik_llama_cpp_tpu.runtime import tokenizer as JT
from ik_llama_cpp_tpu_torch.runtime import chat as TC
from ik_llama_cpp_tpu_torch.runtime import grammar as TG
from ik_llama_cpp_tpu_torch.runtime import json_schema as TJ
from ik_llama_cpp_tpu_torch.runtime import sampling as TS
from ik_llama_cpp_tpu_torch.runtime import tokenizer as TT

JSON_GBNF = r'''
root ::= object
value ::= object | array | string | number | ("true" | "false" | "null") ws
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}" ws
array ::= "[" ws ( value ("," ws value)* )? "]" ws
string ::= "\"" ( [^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F]) )* "\"" ws
number ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? ws
ws ::= [ \t\n]*
'''

GRAMMARS = {
    "json": (JSON_GBNF, ['{}', '{"a": 1}', '{"a": [1, 2, {"b": "c"}], "d": true}',
                         '{"x": -1.5e3}', '{', '{"a"}', '{a: 1}', '[1]', '{"a": 1}}']),
    "classes": ('root ::= [a-z0-9]+ [^x]', ["abc1y", "abcx", "ABC1y", "a", "9z"]),
    "repetition": ('root ::= "a"{2,3} "b"? ("cd")*',
                   ["aa", "aaa", "aaaa", "aab", "aabcdcd", "ab", "aabcdc"]),
    "alternation": ('root ::= greet " " name\ngreet ::= "hi" | "hello"\n'
                    'name ::= [A-Z] [a-z]*', ["hi Bob", "hello Al", "hey Bob", "hi bob"]),
    "unicode": ('root ::= "\\u00e9" [\\u4e00-\\u9fff]+', ["é中文", "é", "e中"]),
}


def _verdicts(mod, g_text, texts):
    out = []
    for s in texts:
        g = mod.Grammar(g_text)
        ok = g.accept_text(s)
        out.append((ok, ok and g.done))
    return out


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_grammar_accepts_and_rejects_alike(name):
    g_text, texts = GRAMMARS[name]
    assert _verdicts(JG, g_text, texts) == _verdicts(TG, g_text, texts)


def _refusal(mod, text):
    try:
        mod.Grammar(text)
    except Exception as e:       # noqa: BLE001 - the kind is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("bad", ['foo ::= "a"', 'root ::= "a', 'root ::= [a-',
                                 'root ::= ('])
def test_parse_errors_alike(bad):
    """Refused alike (the JAX parser runs off the end of some texts with an
    IndexError; the port's copy does the same)."""
    kind = _refusal(JG, bad)
    assert kind is not None and kind == _refusal(TG, bad)


SCHEMAS = [
    {"type": "object",
     "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                    "tags": {"type": "array", "items": {"type": "string"}},
                    "kind": {"enum": ["a", "b"]}},
     "required": ["name", "age", "tags", "kind"]},
    {"type": "array", "items": {"type": "number"}, "minItems": 1, "maxItems": 3},
    {"type": "string", "pattern": "^[a-z]{2,4}-[0-9]+$"},
    {"oneOf": [{"type": "boolean"}, {"type": "null"}]},
    {},
]


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_gbnf_alike(i):
    a, b = JJ.json_schema_to_gbnf(SCHEMAS[i]), TJ.json_schema_to_gbnf(SCHEMAS[i])
    assert a == b
    doc = ['{"name": "bob", "age": 3, "tags": ["x"], "kind": "a"}', "[1, 2.5]",
           '"ab-12"', "true", '{"k": [1]}'][i]
    assert _verdicts(JG, a, [doc, doc[:-1]]) == _verdicts(TG, b, [doc, doc[:-1]])
    assert TG.Grammar(b).accept_text(doc)


def test_tool_call_gbnf_alike():
    tools = [{"type": "function", "function": {
        "name": "get_weather", "parameters": {
            "type": "object", "properties": {"city": {"type": "string"}},
            "required": ["city"]}}}]
    assert JJ.tool_call_gbnf(tools) == TJ.tool_call_gbnf(tools)


def test_grammar_sampler_picks_alike():
    """GrammarSampler.filter_and_pick over the same logits and seed: the
    same tokens, greedy and sampled, until the grammar is done."""
    tokens, scores, types = byte_vocab()

    def tok(mod):
        return mod.Tokenizer(model="llama", tokens=tokens,
                             scores=np.asarray(scores, np.float32),
                             token_types=np.asarray(types, np.int32), merges=None,
                             bos_id=1, eos_id=2, unk_id=0)
    g_text = 'root ::= "{\\"n\\": " [0-9]+ "}"'
    for kw in (dict(temp=0.0), dict(temp=1.0, top_k=50, top_p=0.9, min_p=0.0)):
        picks = []
        for G, S, T in ((JG, JS, JT), (TG, TS, TT)):
            gs = G.GrammarSampler(G.Grammar(g_text), tok(T))
            rng, lrng = np.random.default_rng(2), np.random.default_rng(3)
            out = []
            while not gs.grammar.done and len(out) < 12:
                logits = lrng.standard_normal(len(tokens)).astype(np.float32)
                out.append(gs.filter_and_pick(logits, S.SamplerParams(**kw), rng))
            picks.append(out)
        assert picks[0] == picks[1] and picks[0]


MSGS = [{"role": "system", "content": "You are helpful."},
        {"role": "user", "content": "Hi there"},
        {"role": "assistant", "content": "Hello! <think>hm</think> How can I help?"},
        {"role": "user", "content": [{"type": "text", "text": "part1 "},
                                     {"type": "text", "text": "part2"}]}]


@pytest.mark.parametrize("name", sorted(JC.FALLBACK_TEMPLATES))
@pytest.mark.parametrize("gen", [True, False])
def test_builtin_templates_alike(name, gen):
    assert sorted(JC.FALLBACK_TEMPLATES) == sorted(TC.FALLBACK_TEMPLATES)
    a = JC.apply_chat_template(MSGS, template=name, add_generation_prompt=gen)
    b = TC.apply_chat_template(MSGS, template=name, add_generation_prompt=gen)
    assert a == b and "Hi there" in b


def test_jinja_template_alike():
    pytest.importorskip("jinja2")
    tmpl = ("{% for m in messages %}<{{ m.role }}>{{ m.content }}</{{ m.role }}>"
            "{% endfor %}{% if tools %}{{ tools | tojson }}{% endif %}"
            "{% if add_generation_prompt %}<assistant>{% endif %}")
    tools = [{"type": "function", "function": {"name": "f"}}]
    for kw in (dict(), dict(tools=tools)):
        a = JC.apply_chat_template(MSGS, template=tmpl, **kw)
        b = TC.apply_chat_template(MSGS, template=tmpl, **kw)
        assert a == b and b.endswith("<assistant>")
    bad = "{{ unknown_fn() }}<|im_start|>"      # a failing template: the same fallback
    assert JC.apply_chat_template(MSGS, template=bad) == \
        TC.apply_chat_template(MSGS, template=bad)


@pytest.mark.parametrize("src", [None, "<|im_start|>", "<|start_header_id|>",
                                 "<start_of_turn>", "[INST] <<SYS>>", "[INST]",
                                 "<|end|><|assistant|>", "<|assistant|>", "x"])
def test_detect_template_name_alike(src):
    assert JC.detect_template_name(src) == TC.detect_template_name(src)


OUTPUTS = [
    'ok <tool_call>{"name": "f", "arguments": {"a": 1}}</tool_call>',
    '[TOOL_CALLS][{"name": "g", "arguments": {"b": "x"}}]',
    '{"name": "h", "parameters": {"c": true}}',
    "<function=k>{\"d\": 2}</function>",
    "<think>reasoning here</think>the answer",
    "<think>unterminated reasoning",
    "plain text with no calls",
]


@pytest.mark.parametrize("text", OUTPUTS)
def test_reasoning_and_tool_calls_alike(text):
    assert JC.split_reasoning(text) == TC.split_reasoning(text)
    (jc, jcalls), (tc, tcalls) = JC.parse_tool_calls(text), TC.parse_tool_calls(text)
    assert jc == tc
    strip = lambda c: {k: v for k, v in c.to_openai().items() if k != "id"}
    assert [strip(c) for c in jcalls] == [strip(c) for c in tcalls]
    assert all(json.loads(c.arguments) is not None for c in tcalls)
