"""The port's server: its request logic through ``Server``'s methods in
process (no HTTP), and the aiohttp app booted in a subprocess with
``--device cpu`` on the tiny fixture, as tests/test_server.py boots the JAX
one."""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from fixtures import make_tiny_llama_gguf
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
    with pytest.raises(RequestError) as e:
        srv.completion({"prompt": "x", "grammar": "a+", "grammar_kind": "regex"})
    assert e.value.status == 400 and "not ported" in e.value.payload["error"]["message"]
    with pytest.raises(RequestError) as e:
        srv.completion({"prompt": [1, 10 ** 6], "n_predict": 2})
    assert e.value.status == 500 and e.value.payload["error"]["type"] == "server_error"
    assert srv.engine.alive
    g = srv.completion({"prompt": "Hi", "n_predict": 8, "temperature": 0,
                        "grammar": 'root ::= [a-z]+'})
    assert g["content"] and g["content"].isalpha()
    assert sse(DONE) == b"data: [DONE]\n\n"


TOOLS = [{"type": "function", "function": {"name": "f", "parameters": {"type": "object"}}}]


@pytest.mark.parametrize("extra", [
    {"banned_strings": ["the"]}, {"banned_regex": ["t.e"]}, {"banned_regex_ci": ["T"]},
    {"reasoning_budget": 4}, {"grammar_lazy": True, "grammar": "root ::= [a-z]+"},
    {"post_sampling_probs": True, "n_probs": 2}, {"allowlist_unicode_rules": [["Latin"]]},
    {"tools": TOOLS, "tool_choice": "required"},
    {"tools": TOOLS, "tool_choice": {"type": "function", "function": {"name": "f"}}}])
def test_later_request_options_refused(srv, extra):
    """Request options of later slices are refused with a 400 before they
    reach the engine."""
    n = srv.engine.n_requests
    body = {"messages": [{"role": "user", "content": "Hi"}], "max_tokens": 2, **extra}
    with pytest.raises(RequestError) as e:
        srv.oai_chat(body)
    assert e.value.status == 400 and "not ported" in e.value.payload["error"]["message"]
    assert srv.engine.n_requests == n


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
def http(model):
    pytest.importorskip("aiohttp")
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k in ("PATH", "HOME", "TMPDIR")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ik_llama_cpp_tpu_torch.server", "--gguf", str(model),
         "--port", str(port), "--parallel", "2", "--ctx-size", "256",
         "--device", "cpu"],
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
