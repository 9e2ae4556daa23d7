"""The port's server: its request logic through ``Server``'s methods in
process (no HTTP), and the aiohttp app booted in a subprocess with
``--device cpu`` on the tiny fixture, as tests/test_server.py boots the JAX
one."""
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from fixtures import make_tiny_llama_gguf, make_tiny_mmproj_gguf
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.server.app import DONE, RequestError, Server, sse
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("srv") / "m.gguf", seed=1)


@pytest.fixture(scope="module")
def srv(model):
    eng = BatchEngine(Runtime.from_gguf(model, device="cpu"), n_slots=2, capacity=256)
    eng.start()
    yield Server(eng, model_name="tiny")
    eng.stop()


def test_completion_in_process(srv):
    r = srv.completion({"prompt": "Once upon", "n_predict": 6, "temperature": 0,
                        "return_tokens": True})
    assert r["stop"] and r["tokens_predicted"] == len(r["tokens"]) == 6
    assert r["content"] == srv.rt.detokenize(r["tokens"])
    assert r["tokens_evaluated"] == len(srv.rt.tokenizer.encode("Once upon"))
    events = list(srv.completion_stream({"prompt": "Once upon", "n_predict": 6,
                                         "temperature": 0, "return_tokens": True}))
    assert events[-1]["data"]["tokens"] == r["tokens"]
    assert "".join(e["data"]["content"] for e in events) == r["content"]


def test_oai_endpoints_in_process(srv):
    r = srv.oai_chat({"messages": [{"role": "user", "content": "Hi"}],
                      "max_tokens": 5, "temperature": 0.8, "seed": 3})
    assert r["object"] == "chat.completion"
    assert r["choices"][0]["message"]["role"] == "assistant"
    assert 1 <= r["usage"]["completion_tokens"] <= 5
    chunks = list(srv.oai_chat_stream({"messages": [{"role": "user", "content": "Hi"}],
                                       "max_tokens": 5, "temperature": 0.8, "seed": 3}))
    assert chunks[-1] == DONE
    assert chunks[-2]["data"]["choices"][0]["finish_reason"] in ("stop", "tool_calls")
    text = "".join(c["data"]["choices"][0]["delta"].get("content", "")
                   for c in chunks[:-1])
    assert text == (r["choices"][0]["message"]["content"] or "")
    c = srv.oai_completions({"prompt": "Hello", "max_tokens": 4, "temperature": 0,
                             "logprobs": 2})
    assert c["object"] == "text_completion" and len(c["choices"][0]["logprobs"]["tokens"]) == 4
    resp = srv.oai_responses({"input": "Hi", "max_output_tokens": 4, "temperature": 0})
    assert resp["object"] == "response" and resp["status"] == "completed"
    names = [e["event"] for e in srv.oai_responses_stream(
        {"input": "Hi", "max_output_tokens": 4, "stream": True})]
    assert names[0] == "response.created" and names[-1] == "response.completed"


def test_get_endpoints_and_templates(srv):
    assert srv.health() == {"status": "ok"}
    assert srv.props()["n_parallel"] == 2 and srv.models()["data"][0]["id"] == "tiny"
    assert "llamacpp:requests_total" in srv.metrics()
    assert len(srv.slots()) == 2
    toks = srv.tokenize({"content": "Hello world", "with_pieces": True})["tokens"]
    assert [t["piece"] for t in toks] == [srv.rt.detokenize([t["id"]]) for t in toks]
    assert "Hello" in srv.detokenize({"tokens": [t["id"] for t in toks]})["content"]
    p = srv.apply_template({"messages": [{"role": "user", "content": "Hi"}]})["prompt"]
    assert "<|im_start|>user\nHi" in p          # chatml when the GGUF has none


def test_requests_refused_and_failed(srv):
    with pytest.raises(RequestError) as e:
        srv.completion({"prompt": "x", "grammar": "root ::= (", "n_predict": 2})
    assert e.value.status == 400
    r = srv.completion({"prompt": "x", "grammar": "a+", "grammar_kind": "regex",
                        "n_predict": 4, "temperature": 0})
    assert r["content"] and set(r["content"]) == {"a"}      # a regex grammar is served
    with pytest.raises(RequestError) as e:
        srv.completion({"prompt": "x", "grammar": "a", "grammar_kind": "nope"})
    assert e.value.status == 400 and "grammar kind" in e.value.payload["error"]["message"]
    with pytest.raises(RequestError) as e:
        srv.completion({"prompt": [1, 10 ** 6], "n_predict": 2})
    assert e.value.status == 500 and e.value.payload["error"]["type"] == "server_error"
    assert srv.engine.alive
    g = srv.completion({"prompt": "Hi", "n_predict": 8, "temperature": 0,
                        "grammar": 'root ::= [a-z]+'})
    assert g["content"] and g["content"].isalpha()
    assert sse(DONE) == b"data: [DONE]\n\n"


TOOLS = [{"type": "function", "function": {"name": "f", "parameters": {
    "type": "object", "properties": {"unit": {"enum": ["c", "f"]}}, "required": ["unit"],
    "additionalProperties": False}}}]


@pytest.mark.parametrize("extra", [
    {"banned_strings": ["the"]}, {"banned_regex": ["t.e"]}, {"banned_regex_ci": ["T"]},
    {"reasoning_budget": 4}, {"grammar_lazy": True, "grammar": "root ::= [a-z]+"},
    {"post_sampling_probs": True, "n_probs": 2}, {"allowlist_unicode_rules": [["Latin"]]},
    {"tools": TOOLS, "tool_choice": "required"},
    {"tools": TOOLS, "tool_choice": {"type": "function", "function": {"name": "f"}}}])
def test_later_request_options_refused(srv, extra):
    """The request options of the server-extras slice, refused before it,
    are now served: each request reaches the engine and completes, and
    each option holds on its output (no banned match, Latin-script text
    only, the post-sampling probabilities, the forced call)."""
    n = srv.engine.n_requests
    body = {"messages": [{"role": "user", "content": "Hi"}], "max_tokens": 8,
            "temperature": 0, **extra}
    if "tool_choice" in extra:
        body["max_tokens"] = 60     # the call is 42 byte tokens
    r = srv.oai_chat(body)
    assert srv.engine.n_requests == n + 1 and r["object"] == "chat.completion"
    msg = r["choices"][0]["message"]
    text = msg["content"] or ""
    if "banned_strings" in extra:
        assert "the" not in text.lower()
    if "banned_regex" in extra:
        assert not re.search("t.e", text)
    if "banned_regex_ci" in extra:
        assert "t" not in text.lower()
    if "allowlist_unicode_rules" in extra:
        from ik_llama_cpp_tpu_torch.runtime.allowlist import script_of
        assert all(script_of(ord(c)) in ("latin", "common", "inherited") or c == "\ufffd"
                   for c in text)
    if "post_sampling_probs" in extra:
        lp = r["choices"][0]["logprobs"]["content"]
        assert lp and all(x["top_logprobs"][0]["logprob"] == 0.0 for x in lp)
    if "tool_choice" in extra:
        assert [c["function"]["name"] for c in msg["tool_calls"]] == ["f"]
        assert json.loads(msg["tool_calls"][0]["function"]["arguments"])["unit"] in "cf"


IMAGE = {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}


def _profile(srv):
    """POST /profiler/start, one request, /profiler/stop: the Chrome trace
    written, and a second stop refused as in the JAX routes."""
    d = Path(srv.slot_save_path) / "trace"
    assert srv.profiler_start({"dir": str(d)}) == {"success": True, "dir": str(d)}
    with pytest.raises(RequestError) as e:
        srv.profiler_start({})
    assert e.value.status == 400 and e.value.payload["error"] == "profiler already running"
    srv.completion({"prompt": "Once", "n_predict": 2, "temperature": 0})
    out = srv.profiler_stop({})
    assert out["success"] and json.loads(Path(out["trace"]).read_text())["traceEvents"]
    srv.profiler_stop({})          # not running: raises below


@pytest.mark.parametrize("call,item", [
    (lambda srv: srv.oai_chat({"messages": [{"role": "user", "content": [
        {"type": "text", "text": "Hi"}, IMAGE]}], "max_tokens": 2}), "--mmproj"),
    (lambda srv: srv.anthropic_messages({"messages": [{"role": "user", "content": [
        {"type": "image", "source": {}}]}]}), "/v1/messages"),
    (_profile, "profiler not running"),
    (lambda srv: srv.webui(), "")], ids=["image", "anthropic-image", "profiler", "webui"])
def test_later_slices_refused_by_name(srv, call, item, tmp_path):
    """What the port once left for later (the name is kept): an image chat
    with no --mmproj loaded is a 400 that names it (the JAX server templates
    the parts as text), an Anthropic image block a 400 (the JAX server drops
    it without a word); the profiler routes run (the last stop, with none
    running, is the JAX routes' 400) and GET / serves the web UI. No
    refusal reaches the engine."""
    srv.slot_save_path = str(tmp_path)
    n = srv.engine.n_requests
    if not item:
        html = call(srv)
        assert html.lstrip().lower().startswith("<!doctype html") and "</html>" in html
        return
    with pytest.raises(RequestError) as e:
        call(srv)
    msg = e.value.payload.get("error")
    msg = msg["message"] if isinstance(msg, dict) else msg
    assert e.value.status == 400 and item in msg
    assert srv.engine.n_requests == n + (call is _profile)


def test_later_runtime_and_flags_refused(srv, model):
    """Once refused (the name is kept): reload_changed_tensors runs on a
    runtime loaded with track_reload and, as in JAX, raises without it;
    --mmproj and --swa-compress parse."""
    from ik_llama_cpp_tpu_torch.server.app import parse_args
    with pytest.raises(RuntimeError, match="track_reload"):
        srv.rt.reload_changed_tensors()
    assert Runtime.from_gguf(model, device="cpu", track_reload=True).reload_changed_tensors() \
        is False
    a = parse_args(["--gguf", "m.gguf", "--mmproj", "p.gguf", "--swa-compress"])
    assert a.mmproj == "p.gguf" and a.swa_compress


BODIES = [
    {}, {"temperature": 0.5, "top_k": 7, "top_p": 0.9, "min_p": 0.1, "repeat_penalty": 1.1,
         "repeat_last_n": 16, "frequency_penalty": 0.2, "presence_penalty": 0.1},
    {"logit_bias": {"5": -1.0}, "ignore_eos": True}, {"logit_bias": [[5, False], [6, 2.0]]},
    {"dry_multiplier": 0.8}, {"dry_multiplier": 0.5, "dry_sequence_breakers": ["\n", "x"]},
    {"penalize_nl": False}, {"samplers": "top_k;temperature"},
    {"mirostat": 2, "mirostat_tau": 4.0, "mirostat_eta": 0.2},
    {"adaptive_target": 0.5, "min_keep": 3, "xtc_probability": 0.5, "top_n_sigma": 1.0},
    {"n_probs": 3}, {"logprobs": True, "top_logprobs": 4}, {"logprobs": 2},
    {"grammar": "root ::= [a-z]+"},
    {"json_schema": {"type": "object", "properties": {"a": {"type": "integer"}}}},
    {"response_format": {"type": "json_object"}},
    {"response_format": {"type": "json_schema", "json_schema": {"schema": {"type": "string"}}}}]


@pytest.mark.parametrize("body", BODIES)
def test_request_fields_match_jax(srv, body):
    """A body's sampler, top-logprob count and grammar are the JAX
    server's (same tokenizer for both)."""
    from ik_llama_cpp_tpu.server import app as japp
    from ik_llama_cpp_tpu_torch.server import app as tapp
    tok = srv.rt.tokenizer
    assert vars(tapp._sampler_from(body, tok)) == vars(japp._sampler_from(body, tok))
    assert tapp._n_probs_from(body) == japp._n_probs_from(body)
    assert tapp._grammar_from(body) == japp._grammar_from(body)


def test_stream_payload_options(srv):
    ev = list(srv.completion_stream({"prompt": "Hi", "n_predict": 3, "temperature": 0,
                                     "timings_per_token": True}))
    assert all("predicted_per_token_ms" in e["data"]["timings"] for e in ev[:-1])
    ev = list(srv.oai_completions_stream({"prompt": "Hi", "max_tokens": 3, "temperature": 0,
                                          "stream_options": {"include_usage": True}}))
    assert ev[-1] == DONE and ev[-2]["data"]["usage"]["completion_tokens"] == 3


def test_api_key(srv):
    """Every route but /health wants the key, as a Bearer token or x-api-key."""
    pytest.importorskip("aiohttp")
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer
    from ik_llama_cpp_tpu_torch.server.app import make_app

    async def run():
        keyed = Server(srv.engine, model_name="tiny", api_key="k")
        async with TestClient(TestServer(make_app(keyed))) as c:
            return [(await c.get(path, headers=h)).status for path, h in (
                ("/health", {}), ("/props", {}), ("/props", {"Authorization": "Bearer k"}),
                ("/props", {"x-api-key": "k"}), ("/props", {"x-api-key": "j"}))]
    assert asyncio.run(run()) == [200, 401, 200, 200, 401]


def test_tool_choice_none_hides_the_tools(srv):
    body = {"messages": [{"role": "user", "content": "Hi"}], "tools": TOOLS}
    assert Server._apply_tool_choice({**body, "tool_choice": "none"})["tools"] is None
    assert Server._apply_tool_choice({**body, "tool_choice": "auto"}) == {**body, "tool_choice": "auto"}
    r = srv.oai_chat({**body, "tool_choice": "none", "max_tokens": 2, "temperature": 0})
    assert r["choices"][0]["message"]["role"] == "assistant"


# ------------------------------------------------------------------ HTTP
def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def req(port, path, body=None, raw=False):
    url = f"http://127.0.0.1:{port}{path}"
    if body is None:
        r = urllib.request.urlopen(url, timeout=30)
    else:
        r = urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=60)
    data = r.read()
    return data if raw else json.loads(data)


@pytest.fixture(scope="module")
def http_dir(tmp_path_factory):
    """The served model's slot save path and session store."""
    return tmp_path_factory.mktemp("http")


@pytest.fixture(scope="module")
def mmproj(tmp_path_factory):
    return make_tiny_mmproj_gguf(tmp_path_factory.mktemp("mmproj") / "mmproj.gguf", seed=4)


@pytest.fixture(scope="module")
def http(model, http_dir, mmproj):
    pytest.importorskip("aiohttp")
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k in ("PATH", "HOME", "TMPDIR")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ik_llama_cpp_tpu_torch.server", "--gguf", str(model),
         "--port", str(port), "--parallel", "2", "--ctx-size", "256",
         "--device", "cpu", "--slot-save-path", str(http_dir),
         "--sql-save-file", str(http_dir / "sessions.db"), "--mmproj", str(mmproj),
         "--swa-compress"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        for _ in range(120):
            try:
                req(port, "/health")
                break
            except Exception:
                if proc.poll() is not None:
                    raise RuntimeError(proc.stderr.read().decode()[-2000:])
                time.sleep(0.5)
        else:
            raise RuntimeError("server did not start")
        yield port
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_http_health_tokenize(http):
    assert req(http, "/health")["status"] == "ok"
    r = req(http, "/tokenize", {"content": "Hello world"})
    assert len(r["tokens"]) > 2
    assert "Hello" in req(http, "/detokenize", {"tokens": r["tokens"]})["content"]
    assert b"llamacpp:tokens_predicted_total" in req(http, "/metrics", raw=True)


def test_http_completion(http):
    r = req(http, "/completion", {"prompt": "Once upon", "n_predict": 6,
                                  "temperature": 0, "return_tokens": True})
    assert r["stop"] is True and r["tokens_predicted"] == 6
    raw = req(http, "/completion", {"prompt": "Once upon", "n_predict": 6,
                                    "temperature": 0, "stream": True}, raw=True)
    events = [json.loads(e.removeprefix("data: "))
              for e in raw.decode().split("\n\n") if e.strip()]
    assert events[-1]["stop"] is True and events[-1]["tokens_predicted"] == 6
    assert "".join(e["content"] for e in events) == r["content"]


def test_http_chat_completion(http):
    r = req(http, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "Hi"}], "max_tokens": 5,
             "temperature": 0})
    assert r["object"] == "chat.completion"
    assert r["choices"][0]["message"]["role"] == "assistant"
    assert r["usage"]["completion_tokens"] >= 1
    with pytest.raises(urllib.error.HTTPError) as e:
        req(http, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": "Hi"}], "grammar": "root ::= ("})
    assert e.value.code == 400


def test_http_slots_sessions_anthropic(http, http_dir):
    """The routes of the server-extras slice over HTTP: slot save, list,
    erase and restore with the saved-file routes and their traversal
    guard; the session store; /version and /v1/props; Anthropic's
    /v1/messages and count_tokens."""
    r = req(http, "/completion", {"prompt": "Once upon", "n_predict": 4, "temperature": 0,
                                  "id_slot": 0})
    assert r["tokens_predicted"] == 4
    lists = req(http, "/slots/list")
    slot = max(lists, key=lambda x: x["token_count"])["slot_id"]
    saved = req(http, f"/slots/{slot}?action=save", {"filename": "a.bin"})
    assert saved["n_saved"] > 0 and (http_dir / "a.bin").is_file()
    (listing,) = [f for f in req(http, "/list") if f["filename"] == "a.bin"]
    assert listing["token_count"] == saved["n_saved"]
    assert req(http, f"/slots/{slot}?action=erase", {})["n_erased"] == saved["n_saved"]
    assert req(http, f"/slots/{slot}?action=restore",
               {"filename": "a.bin"})["n_restored"] == saved["n_saved"]
    assert req(http, "/rename_prompt", {"old_filename": "a.bin",
                                        "new_filename": "b.bin"})["filename"] == "b.bin"
    for path, body, code in (("/delete_prompt", {"filename": "../x.bin"}, 400),
                             ("/slots/0?action=restore", {"filename": "gone.bin"}, 404),
                             ("/slots/9?action=save", {}, 400),
                             ("/load", {"storeName": "sessions", "key": "none"}, 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            req(http, path, body)
        assert e.value.code == code, path
    assert req(http, "/delete_prompt", {"filename": "b.bin"})["status"] == "deleted"
    assert req(http, "/save", {"storeName": "sessions", "key": "k", "data": {"a": 1}})["ok"]
    assert req(http, "/save", {"storeName": "names", "key": "k", "data": "chat"})["ok"]
    assert req(http, "/load", {"storeName": "sessions", "key": "k"})["result"] == {"a": 1}
    assert req(http, "/sessions")["result"] == {"k": "chat"}
    assert req(http, "/rename", {"key": "k", "newName": "renamed"})["ok"]
    assert req(http, "/sessions", {})["result"] == {"k": "renamed"}
    assert req(http, "/all", {"storeName": "sessions"})["result"] == {"k": {"a": 1}}
    assert req(http, "/delete", {"storeName": "sessions", "key": "k"})["ok"]
    assert req(http, "/vacuum")["ok"]
    assert req(http, "/version")["features"]["sql"] is True
    assert req(http, "/v1/props")["n_past"] >= saved["n_saved"]
    msg = req(http, "/v1/messages", {"messages": [{"role": "user", "content": "Hi"}],
                                     "max_tokens": 4, "temperature": 0})
    assert msg["type"] == "message" and msg["usage"]["output_tokens"] == 4
    raw = req(http, "/v1/messages", {"messages": [{"role": "user", "content": "Hi"}],
                                     "max_tokens": 4, "temperature": 0, "stream": True}, raw=True)
    names = [b.split("\n")[0] for b in raw.decode().split("\n\n") if b.strip()]
    assert names[0] == "event: message_start" and names[-1] == "event: message_stop"
    n = req(http, "/v1/messages/count_tokens",
            {"messages": [{"role": "user", "content": "Hi"}]})["input_tokens"]
    prompt = req(http, "/apply-template", {"messages": [{"role": "user", "content": "Hi"}]})
    assert n == len(req(http, "/tokenize", {"content": prompt["prompt"],
                                            "add_special": True})["tokens"])


def test_allowlist_and_bias_flags():
    """--allowlist-unicode-rule appends to the current ruleset and
    --allowlist-keyword closes it, in the flags' order (common.cpp:2327);
    the other server-extras flags parse."""
    from ik_llama_cpp_tpu_torch.runtime.allowlist import parse_rule
    from ik_llama_cpp_tpu_torch.server.app import allowlist_defaults, parse_args
    args = parse_args(["--gguf", "m.gguf", "--allowlist-unicode-rule", "latin",
                       "--allowlist-unicode-rule", "0..127", "--allowlist-keyword", "STOP",
                       "--allowlist-unicode-rule", "greek:1", "--allowlist-pieces", "ok",
                       "--allowlist-keyword-delay", "3", "--expiring-logit-bias-file", "b.txt",
                       "--slot-save-path", "slots", "--sql-save-file", "s.db"])
    rules, kws = allowlist_defaults(args.allow_seq)
    assert rules == [[parse_rule("latin"), parse_rule("0..127")], [parse_rule("greek:1")]]
    assert kws == ["STOP"] and args.allowlist_pieces == ["ok"]
    assert (args.allowlist_keyword_delay, args.expiring_logit_bias_file, args.slot_save_path,
            args.sql_save_file) == (3, "b.txt", "slots", "s.db")
    assert allowlist_defaults(parse_args(["--gguf", "m.gguf"]).allow_seq) == ([], [])


def test_http_multimodal_profiler_webui(http, http_dir):
    """--mmproj over HTTP: /props' modalities and a PNG chat (the tiny CLIP
    tower); GET / serves the web UI as HTML; the profiler routes write a
    Chrome trace into the request's dir, and a stop with none running is a
    400."""
    import base64
    import numpy as np
    from ik_llama_cpp_tpu_torch.runtime.media import encode_png
    assert req(http, "/props")["modalities"] == {"vision": True, "audio": False}
    png = encode_png(np.random.default_rng(0).integers(0, 255, (30, 40, 3), dtype=np.uint8))
    r = req(http, "/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is it?"},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + base64.b64encode(png).decode()}}]}],
        "max_tokens": 4, "temperature": 0})
    assert r["object"] == "chat.completion" and r["usage"]["prompt_tokens"] > 4
    html = urllib.request.urlopen(f"http://127.0.0.1:{http}/", timeout=30)
    assert "text/html" in html.headers["Content-Type"] and b"</html>" in html.read()
    d = http_dir / "trace"
    assert req(http, "/profiler/start", {"dir": str(d)})["success"]
    req(http, "/completion", {"prompt": "Once", "n_predict": 2, "temperature": 0})
    out = req(http, "/profiler/stop", {})
    assert out["success"] and Path(out["trace"]).is_file()
    with pytest.raises(urllib.error.HTTPError) as e:
        req(http, "/profiler/stop", {})
    assert e.value.code == 400
