"""The server's request options in the port against the JAX engine and
server on the tiny fixture, CPU: banned strings and regexes with the
rewind, the reasoning budget, a lazy grammar's trigger,
``post_sampling_probs``, a forced ``tool_choice`` (the same grammar text)
and the Anthropic API (the same fields), then the CLI's session file.

One engine a package serves every case of the file (one slot, greedy).
Tokens and texts must be equal; post-sampling probabilities are held to
2e-2 absolute (the two packages' logits differ by bf16 rounding)."""
import asyncio
import copy
import json
import queue
import re

import numpy as np
import pytest

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.runtime.chat_autoparser import analyze_template as janalyze
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine, Request as JRequest
from ik_llama_cpp_tpu_torch.runtime.chat_autoparser import analyze_template
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.app import Server
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
from test_torch_server_extras import QWEN_LIKE

PROMPT = "Hello world"
N = 24
TOOLS = [{"type": "function", "function": {
    "name": "weather", "parameters": {"type": "object", "properties": {
        "unit": {"enum": ["c", "f"]}}, "required": ["unit"], "additionalProperties": False}}},
    {"type": "function", "function": {"name": "other", "parameters": {"type": "object"}}}]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("opts") / "m.gguf", seed=1)


@pytest.fixture(scope="module")
def engines(model):
    jeng = JEngine(JRuntime.from_gguf(model), n_slots=1, capacity=256)
    eng = BatchEngine(Runtime.from_gguf(model, device="cpu"), n_slots=1, capacity=256)
    jeng.start()
    eng.start()
    yield jeng, eng
    jeng.stop()
    eng.stop()


def _drain(r):
    toks, pieces = [], []
    while True:
        tok, piece, done = r.stream_queue.get(timeout=120)
        toks += [tok] if tok >= 0 else []
        pieces.append(piece)
        if done:
            return toks, "".join(pieces), pieces


def both(engines, prompt=PROMPT, n=N, sampler=None, **kw):
    """One request on each engine: [(tokens, text, request)] JAX first."""
    jeng, eng = engines
    ids = eng.rt.tokenizer.encode(prompt)
    out = []
    for e, R, P in ((jeng, JRequest, JParams), (eng, Request, SamplerParams)):
        r = R(prompt_ids=list(ids), n_predict=n, sampler=P(**(sampler or {"temp": 0.0})),
              stream_queue=queue.Queue(), cache_prompt=False, **copy.deepcopy(kw))
        e.submit(r)
        toks, text, r.pieces = _drain(r)
        out.append((toks, text, r))
    assert eng.n_failed == 0
    return out


@pytest.fixture(scope="module")
def free(engines):
    """The unconstrained greedy run: its tokens, text and streamed pieces
    (a piece a token: no stop string and no ban holds text back)."""
    (jt, jtext, _), (tt, ttext, _) = both(engines)
    assert tt == jt and ttext == jtext
    r = Request(prompt_ids=engines[1].rt.tokenizer.encode(PROMPT), n_predict=N,
                sampler=SamplerParams(temp=0.0), stream_queue=queue.Queue())
    engines[1].submit(r)
    toks, text, pieces = _drain(r)
    assert toks == tt and text == ttext
    return tt, ttext, pieces


def _word(text: str, start: int = 1) -> str:
    """The first run of 2 or 3 ASCII letters in ``text`` from ``start`` on."""
    m = re.compile(r"[A-Za-z]{2,3}").search(text, start)
    if m is None:
        pytest.fail(f"no word in {text!r}")
    return m.group(0)


@pytest.mark.parametrize("field", ["banned_strings", "banned_regex", "banned_regex_ci"])
def test_bans_rewind_match_jax(engines, free, field):
    """A word of the free run banned: both engines rewind to the same
    tokens, the word is gone, and the text before it is the free run's."""
    _, text, _ = free
    w = _word(text)
    pat = {"banned_strings": w.lower(), "banned_regex": re.escape(w),
           "banned_regex_ci": re.escape(w.swapcase())}[field]
    eng = engines[1]
    n0 = eng.n_rewinds
    (jt, jtext, _), (tt, ttext, _) = both(engines, **{field: [pat]})
    assert tt == jt and ttext == jtext
    assert eng.n_rewinds > n0 and w.lower() not in ttext.lower()
    pos = text.lower().find(w.lower())
    assert ttext[:pos] == text[:pos]


def test_reasoning_budget_matches_jax(engines, free):
    """The start tag is a word of the free run; with a budget of 4 the
    forced end tag's tokens follow the 4th token from the tag on."""
    _, text, _ = free
    tag = _word(text)
    (jt, jtext, _), (tt, ttext, r) = both(engines, reasoning_budget=4,
                                          reasoning_start_tag=tag, reasoning_end_tag="</x>")
    assert tt == jt and ttext == jtext
    k = next(i for i in range(len(r.pieces)) if tag in "".join(r.pieces[:i + 1]))
    forced = engines[1].rt.tokenizer.encode("\n</x>\n", add_bos=False)
    assert tt[k + 4:k + 4 + len(forced)] == forced
    assert "</x>" not in "".join(r.pieces[:k + 4])


def test_lazy_grammar_matches_jax(engines, free):
    """The trigger is whole pieces of the free run; from there the text is
    the grammar's: the trigger, then digits."""
    toks, text, pieces = free
    at = [len("".join(pieces[:k])) for k in range(len(pieces))]
    i = next(k for k in range(1, len(pieces) - 2) if re.fullmatch(r"[ A-Za-z]*[A-Za-z]", pieces[k])
             and text.find(pieces[k]) == at[k])
    trig = pieces[i]
    lit = json.dumps(trig)
    g = f"root ::= {lit} [0-9]+\n"
    (jt, jtext, _), (tt, ttext, _) = both(engines, grammar=g, grammar_lazy=True,
                                          grammar_triggers=[trig])
    assert tt == jt and ttext == jtext
    at = ttext.find(trig)
    assert ttext[:at] == text[:at]
    after = ttext[at + len(trig):]
    assert after and after.isdigit()


@pytest.mark.parametrize("sampler", [{"temp": 0.0}, {"temp": 0.8, "top_k": 5, "top_p": 1.0,
                                                      "min_p": 0.0}], ids=["greedy", "top5"])
def test_post_sampling_probs_match_jax(engines, sampler):
    """The chain's candidates and their probabilities at every step of one
    history: greedy runs agree throughout; a sampled run is compared up to
    the first step where the two packages' draws differ (the candidates'
    probabilities still agree there)."""
    (jt, _, jr), (tt, _, tr) = both(engines, n=8, sampler=sampler, n_probs=5,
                                    post_sampling_probs=True, seed=5)
    assert len(tr.probs_out) == len(tt) and len(jr.probs_out) == len(jt)
    if sampler["temp"] == 0.0:
        assert tt == jt
    for t, j in zip(tr.probs_out, jr.probs_out):
        # every candidate (n_probs covers top_k), by id: near-tied logits
        # may list two in either order
        tp, jp = dict(t["top"]), dict(j["top"])
        assert sorted(tp) == sorted(jp)
        np.testing.assert_allclose(np.exp([tp[i] for i in sorted(tp)]),
                                   np.exp([jp[i] for i in sorted(jp)]), atol=2e-2)
        assert sum(np.exp(p) for _, p in t["top"]) <= 1 + 1e-6
        if sampler["temp"] == 0.0:
            assert t["top"][0][0] == t["id"]
        if t["id"] != j["id"]:
            break


@pytest.fixture(scope="module")
def servers(engines):
    from ik_llama_cpp_tpu.server.app import Server as JServer
    jeng, eng = engines
    return JServer(jeng, model_name="tiny"), Server(eng, model_name="tiny")


@pytest.mark.parametrize("choice", ["required", {"type": "function",
                                                 "function": {"name": "weather"}}],
                         ids=["required", "named"])
@pytest.mark.parametrize("template", [None, QWEN_LIKE], ids=["bare", "qwen-like"])
def test_forced_tool_choice_grammar_matches_jax(servers, choice, template):
    pytest.importorskip("jinja2")
    jsrv, _ = servers
    jsrv.chat_analysis = janalyze(template) if template else None
    body = {"messages": [{"role": "user", "content": "Hi"}], "tools": TOOLS,
            "tool_choice": choice}
    want = jsrv._apply_tool_choice(body)
    got = Server._apply_tool_choice(body, analyze_template(template) if template else None)
    assert got["grammar"] == want["grammar"]


def test_forced_tool_call_served(servers):
    """A forced named call on the port's server parses as a call to that
    function, its arguments valid under the schema."""
    _, srv = servers
    r = srv.oai_chat({"messages": [{"role": "user", "content": "Hi"}], "tools": TOOLS,
                      "tool_choice": {"type": "function", "function": {"name": "weather"}},
                      "max_tokens": 80, "temperature": 0})
    (call,) = r["choices"][0]["message"]["tool_calls"]
    assert call["function"]["name"] == "weather"
    assert json.loads(call["function"]["arguments"])["unit"] in ("c", "f")
    assert r["choices"][0]["finish_reason"] == "tool_calls"


def _jax_posts(jeng, calls: list) -> list:
    """POST each (path, body, stream) to a JAX server over ``jeng`` in one
    event loop (an aiohttp app binds to the loop it first runs on)."""
    from aiohttp.test_utils import TestClient, TestServer
    from ik_llama_cpp_tpu.server.app import Server as JServer

    async def run():
        out = []
        async with TestClient(TestServer(JServer(jeng, model_name="tiny").app)) as c:
            for path, body, stream in calls:
                resp = await c.post(path, json=body)
                out.append(await (resp.text() if stream else resp.json()))
        return out
    return asyncio.run(run())


ANTHROPIC = [
    {"messages": [{"role": "user", "content": "Hello"}], "max_tokens": 12, "temperature": 0},
    {"system": [{"type": "text", "text": "Be brief."}], "max_tokens": 10, "temperature": 0,
     "messages": [{"role": "user", "content": [{"type": "text", "text": "Hi"}]},
                  {"role": "assistant", "content": [
                      {"type": "tool_use", "name": "weather", "input": {"unit": "c"}}]},
                  {"role": "user", "content": [
                      {"type": "tool_result", "content": [{"type": "text", "text": "20"}]}]}]},
    {"messages": [{"role": "user", "content": "Weather?"}], "max_tokens": 60, "temperature": 0,
     "tools": [{"name": "weather", "input_schema": TOOLS[0]["function"]["parameters"]}],
     "tool_choice": {"type": "tool", "name": "weather"}}]


@pytest.mark.parametrize("body", ANTHROPIC, ids=["text", "blocks", "forced-tool"])
def test_anthropic_matches_jax(servers, body):
    """/v1/messages: the same fields and content (ids aside), streamed the
    same events; count_tokens the same count, the tokenizer's."""
    pytest.importorskip("aiohttp")
    _, srv = servers
    count = {k: v for k, v in body.items() if k in ("messages", "system")}
    if isinstance(count.get("system"), list):
        count.pop("system")
    want, raw, want_n = _jax_posts(servers[0].engine, [
        ("/v1/messages", body, False), ("/v1/messages", {**body, "stream": True}, True),
        ("/v1/messages/count_tokens", count, False)])
    want_n = want_n["input_tokens"]
    got = srv.anthropic_messages(copy.deepcopy(body))
    strip = lambda r: {**r, "id": None, "content": [{**c, "id": None} if "id" in c else c
                                                    for c in r["content"]]}
    assert strip(got) == strip(want)
    assert got["id"].startswith("msg_")
    if body.get("tool_choice"):
        assert got["content"][-1]["type"] == "tool_use" and got["stop_reason"] == "tool_use"
    jev = [(b.split("\n")[0].removeprefix("event: "), json.loads(b.split("\n")[1][6:]))
           for b in raw.split("\n\n") if b.strip()]
    tev = [(e["event"], e["data"]) for e in srv.anthropic_messages_stream(
        {**copy.deepcopy(body), "stream": True})]
    assert [n for n, _ in tev] == [n for n, _ in jev]
    text = lambda ev: "".join(d["delta"]["text"] for n, d in ev if n == "content_block_delta")
    assert text(tev) == text(jev)
    assert tev[-2][1]["usage"] == jev[-2][1]["usage"]
    got_n = srv.anthropic_count_tokens(count)["input_tokens"]
    assert got_n == want_n == len(srv.rt.tokenizer.encode(srv._chat_prompt(
        ([{"role": "system", "content": count["system"]}] if "system" in count else [])
        + count["messages"])))


def test_cli_prompt_cache(tmp_path, model, capsys):
    """The CLI's session file: a second run of the prompt reuses all of it
    but its last token and gives the first run's greedy tokens; the JAX
    package reads the file the port wrote."""
    from ik_llama_cpp_tpu.runtime import state as jstate
    from ik_llama_cpp_tpu_torch.tools import cli
    f = str(tmp_path / "session.bin")
    args = ["-m", str(model), "-p", PROMPT, "-n", "6", "--temp", "0", "--device", "cpu",
            "--prompt-cache", f]
    cli.main(args)
    first = capsys.readouterr()
    assert "reused 0 cached tokens" in first.err
    cli.main(args)
    second = capsys.readouterr()
    n_prompt = len(Runtime.from_gguf(model, device="cpu").tokenizer.encode(PROMPT))
    assert f"reused {n_prompt - 1} cached tokens" in second.err
    assert second.out == first.out
    meta = jstate.read_state_meta(f)
    assert meta["n_past"] == len(meta["tokens"]) and meta["rows_exact"]


def test_grammar_reaches_the_whole_vocabulary():
    """A grammar whose only conforming token ranks below the 2,048 greedy
    tries (or the sampled rounds) is still met, as the reference's grammar
    sampler masks the whole candidate array on a reject; the JAX package
    raises there."""
    from ik_llama_cpp_tpu.runtime.grammar import Grammar as JGrammar
    from ik_llama_cpp_tpu.runtime.grammar import GrammarSampler as JGrammarSampler
    from ik_llama_cpp_tpu_torch.runtime.grammar import Grammar, GrammarSampler

    class Tok:
        eos_id = 0

        def decode(self, ids):
            return "".join("z" if i == 2999 else "a" for i in ids)

    logits = np.linspace(1.0, -1.0, 3000).astype(np.float32)     # id 2999 ranks last
    for params in (SamplerParams(temp=0.0), SamplerParams(temp=0.8, top_k=40)):
        gs = GrammarSampler(Grammar('root ::= "z"'), Tok())
        assert gs.filter_and_pick(logits, params, np.random.default_rng(0)) == 2999
    with pytest.raises(RuntimeError, match="no grammar-conforming token"):
        JGrammarSampler(JGrammar('root ::= "z"'), Tok()).filter_and_pick(
            logits, JParams(temp=0.0), np.random.default_rng(0))
