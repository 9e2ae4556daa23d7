"""The server's embeddings, rerank and infill routes in the port against the
JAX server's handlers on the CPU, and the server on an encoder-only model.

Each route's JSON from the port's ``Server`` method is held to the JAX
handler's (called with the same body, no HTTP) on the tiny bert fixture:
the same keys, indices, order and token counts, every vector value within
TOL (1e-2 of the largest, the rule of test_torch_bert.py) and every
relevance score within TOL. /infill builds the same fill-in-the-middle
prompt as the JAX handler (each handler's generation stubbed to return the
prompt it was given), and both refuse a model without FIM tokens with a
400. On the bert model the port's engine starts and serves the embeddings,
and refuses a completion with a 400 where the JAX server answers it from
the hidden states read as logits (ROADMAP.md §3)."""
import asyncio
import json

import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.server import app as JA
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from ik_llama_cpp_tpu_torch.server import app as TA
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine as TEngine
from test_torch_archs import rewrite

TOL = 1e-2
ROUTES = {"/embedding": "embeddings", "/embeddings": "embeddings",
          "/v1/embeddings": "oai_embeddings", "/rerank": "rerank", "/v1/rerank": "rerank",
          "/infill": "infill"}


class _Body:
    """The one thing a JAX handler reads from its request."""

    def __init__(self, body):
        self.body = body

    async def json(self):
        return self.body


def _jax(srv, name: str, body: dict):
    """(status, JSON) of a JAX handler."""
    resp = asyncio.run(getattr(srv, name)(_Body(body)))
    return resp.status, json.loads(resp.text)


def _port(srv, name: str, body: dict):
    try:
        return 200, json.loads(json.dumps(getattr(srv, name)(body)))
    except TA.RequestError as e:
        return e.status, e.payload


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    path = F.make_tiny_bert_gguf(tmp_path_factory.mktemp("es") / "b.gguf", seed=5)
    jr, tr = JRuntime.from_gguf(path), TRuntime.from_gguf(path, device="cpu")
    return JA.Server(JEngine(jr, n_slots=1, capacity=64)), TA.Server(TEngine(tr, n_slots=1,
                                                                             capacity=64))


def _close(a, b, where="json"):
    """The same JSON, floats within TOL of the largest float at their level."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list) and a and isinstance(a[0], float):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and np.abs(x - y).max() <= TOL * np.abs(y).max(), where
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), where
    else:
        assert a == b, where


def test_routes_are_served():
    for path, name in ROUTES.items():
        assert TA.POST_ROUTES[path] == name and callable(getattr(TA.Server, name))


@pytest.mark.parametrize("body", [
    {"content": "hello world"},
    {"content": ["hello world", [2, 40, 41, 3]], "pooling": "cls"},
    {"input": "the thing", "pooling": "last"},
], ids=["text", "list", "input-last"])
def test_native_embeddings_match_jax(servers, body):
    js, ts = servers
    (jst, jout), (tst, tout) = _jax(js, "embeddings", body), _port(ts, "embeddings", body)
    assert jst == tst == 200
    _close(tout, jout)


def test_oai_embeddings_match_jax(servers):
    js, ts = servers
    body = {"input": ["a b c", [2, 30, 31, 32, 3], "hello"]}
    (jst, jout), (tst, tout) = (_jax(js, "oai_embeddings", body),
                                _port(ts, "oai_embeddings", body))
    assert jst == tst == 200 and tout["usage"]["prompt_tokens"] > 0
    tout["model"] = jout["model"]
    _close(tout, jout)


@pytest.mark.parametrize("top_n", [3, 2])
def test_rerank_matches_jax(servers, top_n):
    js, ts = servers
    body = {"query": "hello world", "top_n": top_n,
            "documents": ["hello there world", "the thing", {"text": "world"}]}
    (jst, jout), (tst, tout) = _jax(js, "rerank", body), _port(ts, "rerank", body)
    assert jst == tst == 200 and len(tout["results"]) == top_n
    tout["model"] = jout["model"]
    _close(tout, jout)


def test_infill_matches_jax(servers, tmp_path):
    """A model without FIM tokens: a 400 from both. With them (the llama
    fixture given fim ids 5, 6, 7): the same prompt ids and the same JSON
    around the same generation."""
    js, ts = servers
    body = {"input_prefix": "def f(", "input_suffix": "\n  return 1\n"}
    (jst, _), (tst, tout) = _jax(js, "infill", body), _port(ts, "infill", body)
    assert jst == tst == 400 and "fill-in-middle" in tout["error"]["message"]
    path = rewrite(F.make_tiny_llama_gguf(tmp_path / "l.gguf"), tmp_path / "fim.gguf",
                   extra_kv={"tokenizer.ggml.fim_pre_token_id": 5,
                             "tokenizer.ggml.fim_suf_token_id": 6,
                             "tokenizer.ggml.fim_mid_token_id": 7})
    jsrv = JA.Server(JEngine(JRuntime.from_gguf(path), n_slots=1, capacity=64))
    tsrv = TA.Server(TEngine(TRuntime.from_gguf(path, device="cpu"), n_slots=1, capacity=64))
    seen = {}

    async def jrun(ids, body, stream):
        seen["jax"] = list(ids)
        return [1, 2], "ab"

    def trun(ids, body):
        seen["port"] = list(ids)
        return [1, 2], "ab", None

    jsrv._run, tsrv._run = jrun, trun
    (jst, jout), (tst, tout) = _jax(jsrv, "infill", body), _port(tsrv, "infill", body)
    assert jst == tst == 200 and tout == jout == {"content": "ab", "tokens_predicted": 2}
    assert seen["port"] == seen["jax"] and seen["port"].count(7) == 1


def test_server_starts_on_an_encoder(servers):
    """The port's engine on the bert model starts, reports healthy, serves
    the embeddings and refuses a completion with a 400."""
    _, ts = servers
    ts.engine.start()
    try:
        assert ts.health() == {"status": "ok"} and ts.props()["arch"] == "bert"
        assert _port(ts, "embeddings", {"content": "hello"})[0] == 200
        status, err = _port(ts, "completion", {"prompt": "hello world", "n_predict": 3})
        assert status == 400 and "encoder" in err["error"]["message"]
    finally:
        ts.engine.stop()
