"""HTTP server — OpenAI and llama.cpp-native endpoints over the
continuous-batching engine. Analogue of examples/server/server.cpp:2127-2174.

The torch port of the JAX package's ``server/app.py``, split in two:

- ``Server`` holds the request logic with no transport: each endpoint is a
  method that takes the request body (a dict) and returns the result (a
  dict, or text for /metrics); a streaming endpoint's ``*_stream`` method
  returns an iterator of server-sent events (``{"event": name or None,
  "data": payload}``, or ``"[DONE]"``). Scripts and tests call these
  directly, with no HTTP.
- ``make_app`` / ``main`` wrap it in thin aiohttp handlers. aiohttp is
  imported there, at the point of use.

Endpoints: /health /props /v1/models /metrics /slots /tokenize /detokenize
/completion(s) /v1/completions /v1/chat/completions /v1/responses
/apply-template, the embeddings routes /embedding, /embeddings and
/v1/embeddings (``Runtime.embed``: pooled, L2-normalized vectors), /rerank
and /v1/rerank (documents scored by the dot product of their mean-pooled
embeddings with the query's), /infill (a fill-in-the-middle completion
from the tokenizer's FIM tokens), the control vectors' GET
/control-vectors and POST /control-vectors/load, /unload and /apply, and
the LoRA adapters' GET and POST /lora-adapters (adapters given with
``--lora PATH[:SCALE]``, which loads the model with its q/k/v and gate/up
unfused). An encoder-only model (the BERT family) serves the embeddings
and rerank routes and refuses generation with a 400. The other routes of
the JAX server (slot save/restore, sessions, the Anthropic API,
multimodal, the profiler) are later slices of the port.

Run: python -m ik_llama_cpp_tpu_torch.server --gguf model.gguf --port 8080
"""
from __future__ import annotations

import argparse
import json
import queue
import time
import uuid
from pathlib import Path
from typing import Iterator

import numpy as np

from ..runtime.chat import apply_chat_template, parse_tool_calls, split_reasoning
from ..runtime.generate import Runtime
from ..runtime.sampling import DEFAULT_DRY_BREAKERS, SamplerParams
from .engine import BatchEngine, Request

DONE = "[DONE]"


class RequestError(Exception):
    """A request the server refuses (status 400) or failed (status 500)."""

    def __init__(self, status: int, message: str,
                 kind: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.payload = {"error": {"message": message, "type": kind}}


def _sampler_from(body: dict, tok=None) -> SamplerParams:
    bias = {}
    lb = body.get("logit_bias")
    if isinstance(lb, dict):
        bias = {int(k): float(v) for k, v in lb.items()}
    elif isinstance(lb, list):        # native [[tok, bias|false], ...] form
        for item in lb:
            if isinstance(item, (list, tuple)) and len(item) == 2:
                bias[int(item[0])] = -101.0 if item[1] is False else float(item[1])
    kw = {}
    if "samplers" in body:
        s = body["samplers"]
        kw["samplers"] = tuple(s.split(";") if isinstance(s, str) else s)
    # DRY sequence breakers arrive as strings; matching works on token ids.
    # When DRY is enabled without explicit breakers, the reference's
    # defaults ('\n', ':', '"', '*') apply.
    brk = body.get("dry_sequence_breakers")
    if brk is None and float(body.get("dry_multiplier", 0.0)) > 0.0:
        brk = list(DEFAULT_DRY_BREAKERS)
    if brk and tok is not None:
        ids = []
        for s in brk if isinstance(brk, list) else [brk]:
            ids.extend(tok.encode(str(s), add_bos=False))
        kw["dry_sequence_breaker_ids"] = tuple(ids)
    if body.get("ignore_eos") and tok is not None:
        bias[int(tok.eos_id)] = -101.0
    if body.get("penalize_nl") is False and tok is not None:
        nl = tok.encode("\n", add_bos=False)
        if nl:
            kw["penalize_nl"] = False
            kw["nl_token_id"] = int(nl[-1])
    return SamplerParams(
        temp=float(body.get("temperature", 0.8)),
        dynatemp_range=float(body.get("dynatemp_range", 0.0)),
        dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        tfs_z=float(body.get("tfs_z", 1.0)),
        typical_p=float(body.get("typical_p", 1.0)),
        xtc_probability=float(body.get("xtc_probability", 0.0)),
        xtc_threshold=float(body.get("xtc_threshold", 0.1)),
        top_n_sigma=float(body.get("top_n_sigma", 0.0)),
        penalty_last_n=int(body.get("repeat_last_n", 64)),
        penalty_repeat=float(body.get("repeat_penalty", 1.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        dry_multiplier=float(body.get("dry_multiplier", 0.0)),
        dry_base=float(body.get("dry_base", 1.75)),
        dry_allowed_length=int(body.get("dry_allowed_length", 2)),
        dry_penalty_last_n=int(body.get("dry_penalty_last_n", -1)),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        adaptive_target=float(body.get("adaptive_target", -1.0)),
        adaptive_decay=float(body.get("adaptive_decay", 0.9)),
        min_keep=max(1, int(body.get("min_keep", 1))),
        logit_bias=bias,
        **kw,
    )


def _n_probs_from(body: dict) -> int:
    """Top-logprob count: native n_probs, OpenAI completions `logprobs: N`,
    or OpenAI chat `logprobs: true` + `top_logprobs: N`."""
    if body.get("n_probs"):
        return int(body["n_probs"])
    lp = body.get("logprobs")
    if lp is True:
        return max(1, int(body.get("top_logprobs") or 1))
    if isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
        return int(lp)
    return 0


def _grammar_from(body: dict) -> str | None:
    """GBNF grammar text from the request: native ``grammar`` /
    ``json_schema`` fields (server.cpp params_from_json_cmpl) or the OpenAI
    ``response_format`` object (json_object / json_schema types). Other
    ``grammar_kind``s (llguidance) are a later slice: the engine refuses
    them."""
    if body.get("grammar"):
        return str(body["grammar"])
    if body.get("json_schema") is not None:
        from ..runtime.json_schema import json_schema_to_gbnf
        return json_schema_to_gbnf(body["json_schema"])
    rf = body.get("response_format")
    if isinstance(rf, dict):
        t = rf.get("type")
        if t in ("json_object", "json_schema"):
            from ..runtime.json_schema import json_schema_to_gbnf
            js = rf.get("json_schema", rf)
            schema = js.get("schema") if isinstance(js, dict) else None
            return json_schema_to_gbnf(schema if schema is not None else {})
    return None


def _chunk(rid: str, obj: str, model: str, choices: list, **extra) -> dict:
    return {"id": rid, "object": obj, "created": int(time.time()), "model": model,
            "choices": choices, **extra}


class Server:
    """The request logic of every endpoint, with no transport."""

    def __init__(self, engine: BatchEngine, model_name: str = "model",
                 api_key: str | None = None, template: str | None = None):
        self.engine = engine
        self.rt = engine.rt
        self.model_name = model_name
        self.api_key = api_key
        # a built-in template name or jinja source; default: the GGUF's own
        self.template = template or getattr(self.rt.tokenizer, "chat_template", None)
        # loaded control vectors: {"path", "scale", "layer_start",
        # "layer_end" (1-indexed, inclusive), "applied"}
        self.control_vectors: list[dict] = []
        # applied LoRA adapters (runtime/lora.LoraAdapter), in --lora order
        self.loras: list = []

    # ------------------------------------------------------ engine bridge
    def _open(self, prompt_ids: list[int], body: dict,
              holder: dict | None = None) -> tuple[Request, queue.Queue]:
        """Validate the body, build the engine Request and submit it."""
        from ..runtime.grammar import GBNFParseError, Grammar
        kind = str(body.get("grammar_kind") or "gbnf")
        try:
            g_text = _grammar_from(body)
            if g_text is not None and kind in ("gbnf", "grammar"):
                Grammar(g_text)     # validate before admitting -> clean 400
        except (GBNFParseError, ValueError, KeyError, IndexError) as e:
            raise RequestError(400, f"invalid grammar/schema: {e!r}") from e
        q: queue.Queue = queue.Queue()
        req = Request(
            prompt_ids=list(prompt_ids),
            n_predict=int(body.get("n_predict", body.get("max_tokens", 128))),
            sampler=_sampler_from(body, tok=self.rt.tokenizer),
            seed=int(body.get("seed", int(time.time() * 1000) % 2**31)),
            stop=body.get("stop", []) or [],
            grammar=g_text,
            grammar_kind=kind,
            n_probs=_n_probs_from(body),
            n_keep=int(body.get("n_keep", -1)),
            n_discard=int(body.get("n_discard", -1)),
            cache_prompt=bool(body.get("cache_prompt", True)),
            grammar_lazy=bool(body.get("grammar_lazy", False)),
            banned=any(body.get(k) for k in ("banned_strings", "banned_regex",
                                             "banned_regex_ci")),
            reasoning_budget=int(body.get(
                "reasoning_budget", body.get("reasoning_budget_tokens", -1))),
            post_sampling_probs=bool(body.get("post_sampling_probs", False)),
            allow_rules=body.get("allowlist_unicode_rules") or [],
            expiring_logit_bias=body.get("expiring_logit_bias"),
            stream_queue=q,
        )
        try:
            self.engine.submit(req)
        except NotImplementedError as e:
            raise RequestError(400, str(e)) from e
        if holder is not None:
            holder["req"] = req
        return req, q

    @staticmethod
    def _pieces(req: Request, q: queue.Queue) -> Iterator[tuple[int, str, bool]]:
        """(token id, text piece, done) as the engine emits them; raises
        RequestError(500) with the engine's error text if it failed the
        request."""
        while True:
            tok, piece, done = q.get()
            if done and req.error is not None:
                raise RequestError(500, req.error, "server_error")
            yield tok, piece, done
            if done:
                return

    def _run(self, prompt_ids, body: dict):
        """Blocking: (generated token ids, text, the Request)."""
        req, q = self._open(prompt_ids, body)
        toks, text = [], []
        for tok, piece, _ in self._pieces(req, q):
            if tok >= 0:
                toks.append(tok)
            text.append(piece)
        return toks, "".join(text), req

    def _prompt_ids(self, prompt) -> list[int]:
        return list(prompt) if isinstance(prompt, list) else self.rt.tokenizer.encode(prompt)

    def _chat_prompt(self, messages: list[dict], tools: list | None = None) -> str:
        """Render the chat template (the server's, else the GGUF's; chatml
        without either)."""
        return apply_chat_template(messages, template=self.template, tools=tools,
                                   add_generation_prompt=True)

    def _dec(self, t) -> str:
        return self.rt.tokenizer.decode([int(t)])

    @staticmethod
    def _parse_chat_output(text: str):
        """(reasoning, content, tool calls) of a chat completion's text."""
        reasoning, content = split_reasoning(text)
        content, calls = parse_tool_calls(content)
        return reasoning, content, calls

    @staticmethod
    def _apply_tool_choice(body: dict) -> dict:
        """tool_choice 'none' hides the tools; forcing a tool call
        ('required' or a named function) is a later slice: 400."""
        tc = body.get("tool_choice")
        if not body.get("tools") or tc in (None, "auto") or _grammar_from(body) is not None:
            return body
        if tc == "none":
            return {**body, "tools": None}
        raise RequestError(400, f"tool_choice {tc!r} (a forced tool call) is not "
                                "ported yet (the server extras slice of the PyTorch port)")

    # ------------------------------------------------------------ GET
    def health(self) -> dict:
        if not self.engine.alive:
            return {"status": "error", "error": "the engine thread is not running"}
        return {"status": "ok"}

    def props(self) -> dict:
        cfg = self.rt.cfg
        return {
            "model": self.model_name,
            "n_ctx": self.engine.capacity,
            "n_parallel": self.engine.n_slots,
            "arch": cfg.arch,
            "n_layer": cfg.n_layer,
            "n_embd": cfg.n_embd,
            "n_vocab": cfg.n_vocab,
            "chat_template": self.template,
            "default_generation_settings": {
                "temperature": 0.8, "top_k": 40, "top_p": 0.95,
                "min_p": 0.05, "n_predict": 128,
            },
            "total_slots": self.engine.n_slots,
        }

    def metrics(self) -> str:
        return self.engine.metrics_text()

    def models(self) -> dict:
        return {"object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "created": int(time.time()),
                          "owned_by": "ik_llama_cpp_tpu_torch"}]}

    def slots(self) -> list:
        return [{"id": s.idx, "state": s.state.name, "n_past": s.n_past,
                 "n_decoded": s.n_decoded} for s in self.engine.slots]

    def cvec_list(self) -> list:
        """GET /control-vectors (server.cpp:1639)."""
        return [{"id": i, "path": cv["path"], "scale": cv["scale"],
                 "layer_start": cv["layer_start"], "layer_end": cv["layer_end"],
                 "applied": cv["applied"]} for i, cv in enumerate(self.control_vectors)]

    # ------------------------------------------------------------ POST
    def _reapply_cvec(self) -> None:
        """Rebuild the summed steering array from every loaded vector whose
        scale is not 0 (the layer range is 1-indexed and inclusive, as the
        reference's direction.<il> names are) and rebind ``rt.params`` to a
        copy that holds it: the engine thread may be reading the old dict
        for a step at this moment."""
        from ..runtime.cvector import (apply_control_vector, load_control_vector,
                                       remove_control_vector)
        cfg = self.rt.cfg
        total = None
        for cv in self.control_vectors:
            cv["applied"] = cv["scale"] != 0.0
            if cv["applied"]:
                dense = load_control_vector(cv["path"], cfg.n_layer, cfg.n_embd,
                                            scale=cv["scale"],
                                            layer_start=cv["layer_start"] - 1,
                                            layer_end=cv["layer_end"])
                total = dense if total is None else total + dense
        params = dict(self.rt.params)
        if total is None:
            remove_control_vector(params)
        else:
            apply_control_vector(params, total, self.rt.device)
        self.rt.params = params

    @staticmethod
    def _cvec_error(message: str) -> RequestError:
        e = RequestError(400, message)
        e.payload = {"success": False, "error": message}
        return e

    def cvec_load(self, body: dict) -> dict:
        """POST /control-vectors/load {"path", "scale"?, "layer_start"?,
        "layer_end"?} (server-context.cpp:3081). Loading a path again
        updates its parameters."""
        path = body.get("path")
        if not path or not Path(path).is_file():
            raise self._cvec_error("control vector file not found")
        entry = {"path": path, "scale": float(body.get("scale", 1.0)),
                 "layer_start": int(body.get("layer_start", 1)),
                 "layer_end": int(body.get("layer_end", self.rt.cfg.n_layer)),
                 "applied": False}
        try:
            for cv in self.control_vectors:
                if cv["path"] == path:
                    cv.update(entry)
                    break
            else:
                self.control_vectors.append(entry)
            self._reapply_cvec()
        except (OSError, ValueError, KeyError) as e:
            raise self._cvec_error(str(e)) from e
        return {"success": True,
                "id": [cv["path"] for cv in self.control_vectors].index(path)}

    def _cvec_id_ok(self, cid) -> bool:
        return isinstance(cid, int) and 0 <= cid < len(self.control_vectors)

    def cvec_unload(self, body: dict) -> dict:
        """POST /control-vectors/unload {"id"} (server-context.cpp:3158)."""
        cid = body.get("id")
        if not self._cvec_id_ok(cid):
            raise self._cvec_error("Missing or invalid 'id' field")
        self.control_vectors.pop(cid)
        self._reapply_cvec()
        return {"success": True}

    def cvec_apply(self, body) -> dict:
        """POST /control-vectors/apply [{"id", "scale", "layer_start"?,
        "layer_end"?}, ...]: every scale goes to 0, then the given ones are
        set (server.cpp:1690). A bad id changes nothing."""
        entries = body if isinstance(body, list) else [body]
        if not all(self._cvec_id_ok(entry.get("id")) for entry in entries):
            raise self._cvec_error("Invalid control vector id")
        for cv in self.control_vectors:
            cv["scale"] = 0.0
        for entry in entries:
            cv = self.control_vectors[entry["id"]]
            cv["scale"] = float(entry.get("scale", 0.0))
            for key in ("layer_start", "layer_end"):
                if key in entry:
                    cv[key] = int(entry[key])
        self._reapply_cvec()
        return {"success": True}

    def lora_list(self) -> list:
        """GET /lora-adapters (server.cpp /lora-adapters)."""
        return [{"id": i, "path": a.path, "scale": a.scale}
                for i, a in enumerate(self.loras)]

    def lora_set(self, body) -> list:
        """POST /lora-adapters: [{"id": N, "scale": S}, ...] (or one such
        object); an id that names no adapter is skipped, as the JAX server
        does. Only each adapted linear's scale tensor is written, and no
        slot reuses rows cached before the change."""
        from ..runtime.lora import set_lora_scale
        for item in body if isinstance(body, list) else [body]:
            i = int(item.get("id", 0))
            if 0 <= i < len(self.loras):
                set_lora_scale(self.rt.params, float(item.get("scale", 1.0)), self.loras[i])
                self.engine.weights_epoch += 1
        return self.lora_list()

    def tokenize(self, body: dict) -> dict:
        ids = self.rt.tokenizer.encode(body.get("content", ""),
                                       add_bos=bool(body.get("add_special", False)))
        if body.get("with_pieces"):
            return {"tokens": [{"id": int(t), "piece": self._dec(t)} for t in ids]}
        return {"tokens": ids}

    def detokenize(self, body: dict) -> dict:
        return {"content": self.rt.tokenizer.decode(body.get("tokens", []))}

    def apply_template(self, body: dict) -> dict:
        return {"prompt": self._chat_prompt(body.get("messages", []))}

    # ----------------------------------------------- embeddings / rerank
    def _item_ids(self, item) -> list[int]:
        """An input item: a list of token ids as it is, a text encoded."""
        return list(item) if isinstance(item, list) else self.rt.tokenizer.encode(item)

    def embeddings(self, body: dict):
        """Native /embedding(s): {"content": str | ids | [str | ids, ...],
        "pooling": ...} -> {"embedding": [...]} for one item, or [{"index",
        "embedding"}, ...] for a list (each list entry is an item, so one
        id list goes in as [[ids]])."""
        content = body.get("content", body.get("input", ""))
        items = content if isinstance(content, list) else [content]
        pooling = body.get("pooling", "mean")
        out = [{"index": i, "embedding": self.rt.embed(self._item_ids(x), pooling).tolist()}
               for i, x in enumerate(items)]
        return out if isinstance(content, list) else {"embedding": out[0]["embedding"]}

    def oai_embeddings(self, body: dict) -> dict:
        """OpenAI-compatible /v1/embeddings (mean pooling)."""
        inputs = body.get("input", "")
        data, n_tok = [], 0
        for i, x in enumerate(inputs if isinstance(inputs, list) else [inputs]):
            ids = self._item_ids(x)
            n_tok += len(ids)
            data.append({"object": "embedding", "index": i,
                         "embedding": self.rt.embed(ids, "mean").tolist()})
        return {"object": "list", "data": data, "model": self.model_name,
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}}

    def rerank(self, body: dict) -> dict:
        """/rerank: documents scored against a query by the dot product of
        their mean-pooled, normalized embeddings (the generative fallback of
        the reference server's rerank endpoint for a model with no
        classifier head), best first, the top_n of them."""
        docs = body.get("documents", [])
        top_n = int(body.get("top_n", len(docs)))
        qe = self.rt.embed(self.rt.tokenizer.encode(body.get("query", "")), "mean")
        results = []
        for i, d in enumerate(docs):
            text = d if isinstance(d, str) else d.get("text", "")
            de = self.rt.embed(self.rt.tokenizer.encode(text), "mean")
            results.append({"index": i, "relevance_score": float(np.dot(qe, de))})
        results.sort(key=lambda r: -r["relevance_score"])
        return {"model": self.model_name, "results": results[:top_n]}

    def infill(self, body: dict) -> dict:
        """Fill-in-the-middle completion (examples/infill): the prompt
        [BOS] <pre> prefix <suf> suffix <mid> from the tokenizer's FIM ids;
        a model without them is a 400."""
        tok = self.rt.tokenizer
        if tok.fim_pre_id < 0 or tok.fim_suf_id < 0 or tok.fim_mid_id < 0:
            raise RequestError(400, "model has no fill-in-middle tokens")
        pre = tok.encode(body.get("input_prefix", ""), add_bos=False)
        suf = tok.encode(body.get("input_suffix", ""), add_bos=False)
        ids = (([tok.bos_id] if tok.bos_id >= 0 and tok.add_bos else [])
               + [tok.fim_pre_id] + pre + [tok.fim_suf_id] + suf + [tok.fim_mid_id])
        toks, text, _ = self._run(ids, body)
        return {"content": text, "tokens_predicted": len(toks)}

    def completion(self, body: dict) -> dict:
        """llama.cpp-native /completion."""
        ids = self._prompt_ids(body.get("prompt", ""))
        toks, text, req = self._run(ids, body)
        out = {"content": text, "tokens_predicted": len(toks),
               "tokens_evaluated": len(ids), "stop": True, "model": self.model_name}
        if body.get("return_tokens"):
            out["tokens"] = toks
        if req.probs_out:
            out["completion_probabilities"] = [
                {"content": self._dec(p["id"]),
                 "probs": [{"tok_str": self._dec(i), "prob": float(np.exp(lp))}
                           for i, lp in p["top"]]}
                for p in req.probs_out]
        return out

    def completion_stream(self, body: dict, holder: dict | None = None) -> Iterator:
        ids = self._prompt_ids(body.get("prompt", ""))
        req, q = self._open(ids, body, holder)

        def events():
            toks, t_last = [], time.time()
            for tok, piece, done in self._pieces(req, q):
                if tok >= 0:
                    toks.append(tok)
                if piece:
                    payload = {"content": piece, "stop": done}
                    if body.get("timings_per_token"):
                        now = time.time()
                        dt = max(now - t_last, 1e-9)
                        t_last = now
                        payload["timings"] = {
                            "predicted_per_token_ms": round(dt * 1e3, 3),
                            "predicted_per_second": round(1.0 / dt, 2)}
                    yield {"event": None, "data": payload}
            last = {"content": "", "stop": True, "tokens_predicted": len(toks)}
            if body.get("return_tokens"):
                last["tokens"] = toks
            yield {"event": None, "data": last}
        return events()

    def oai_completions(self, body: dict) -> dict:
        ids = self._prompt_ids(body.get("prompt", ""))
        toks, text, req = self._run(ids, body)
        choice = {"index": 0, "text": text, "finish_reason": "stop"}
        if req.probs_out:
            probs = req.probs_out
            choice["logprobs"] = {
                "tokens": [self._dec(p["id"]) for p in probs],
                "token_logprobs": [p["logprob"] for p in probs],
                "top_logprobs": [{self._dec(i): lp for i, lp in p["top"]}
                                 for p in probs],
                "text_offset": [],
            }
        return _chunk(f"cmpl-{uuid.uuid4().hex[:12]}", "text_completion",
                      self.model_name, [choice],
                      usage={"prompt_tokens": len(ids), "completion_tokens": len(toks),
                             "total_tokens": len(ids) + len(toks)})

    def oai_completions_stream(self, body: dict, holder: dict | None = None) -> Iterator:
        ids = self._prompt_ids(body.get("prompt", ""))
        req, q = self._open(ids, body, holder)
        rid = f"cmpl-{uuid.uuid4().hex[:12]}"

        def events():
            n = 0
            for tok, piece, done in self._pieces(req, q):
                n += tok >= 0
                if piece or done:
                    yield {"event": None, "data": _chunk(
                        rid, "text_completion", self.model_name,
                        [{"index": 0, "text": piece,
                          "finish_reason": "stop" if done else None}])}
            so = body.get("stream_options")
            if isinstance(so, dict) and so.get("include_usage"):
                yield {"event": None, "data": _chunk(
                    rid, "text_completion", self.model_name, [],
                    usage={"prompt_tokens": len(ids), "completion_tokens": n,
                           "total_tokens": len(ids) + n})}
            yield DONE
        return events()

    def _chat_ids(self, body: dict) -> tuple[dict, list[int]]:
        body = self._apply_tool_choice(body)
        prompt = self._chat_prompt(body.get("messages", []), tools=body.get("tools"))
        return body, self.rt.tokenizer.encode(prompt)

    def oai_chat(self, body: dict) -> dict:
        body, ids = self._chat_ids(body)
        toks, text, req = self._run(ids, body)
        reasoning, content, calls = self._parse_chat_output(text)
        message = {"role": "assistant", "content": content or None}
        if reasoning:
            message["reasoning_content"] = reasoning
        finish = "stop"
        if calls:
            message["tool_calls"] = [c.to_openai() for c in calls]
            finish = "tool_calls"
        choice = {"index": 0, "message": message, "finish_reason": finish}
        if req.probs_out:
            choice["logprobs"] = {"content": [
                {"token": self._dec(p["id"]), "logprob": p["logprob"],
                 "top_logprobs": [{"token": self._dec(i), "logprob": lp}
                                  for i, lp in p["top"]]}
                for p in req.probs_out]}
        return _chunk(f"chatcmpl-{uuid.uuid4().hex[:12]}", "chat.completion",
                      self.model_name, [choice],
                      usage={"prompt_tokens": len(ids), "completion_tokens": len(toks),
                             "total_tokens": len(ids) + len(toks)})

    def oai_chat_stream(self, body: dict, holder: dict | None = None) -> Iterator:
        """Streamed chat: the accumulated text is parsed again each token
        and reasoning_content / content deltas are emitted; a holdback of
        24 chars keeps half-open markers out of the content mid-stream."""
        body, ids = self._chat_ids(body)
        req, q = self._open(ids, body, holder)
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        holdback = 24

        def emit(delta, finish=None):
            return {"event": None, "data": _chunk(
                rid, "chat.completion.chunk", self.model_name,
                [{"index": 0, "delta": delta, "finish_reason": finish}])}

        def events():
            acc, sent_r, sent_c = "", "", ""
            for _, piece, done in self._pieces(req, q):
                acc += piece
                reasoning, content, _ = self._parse_chat_output(acc)
                delta = {}
                if len(reasoning) > len(sent_r) and reasoning.startswith(sent_r):
                    delta["reasoning_content"] = reasoning[len(sent_r):]
                    sent_r = reasoning
                lim = len(content) if done else max(0, len(content) - holdback)
                if lim > len(sent_c) and content.startswith(sent_c):
                    delta["content"] = content[len(sent_c):lim]
                    sent_c = content[:lim]
                if delta:
                    yield emit(delta)
            _, _, calls = self._parse_chat_output(acc)
            if calls:
                yield emit({"tool_calls": [
                    {"index": i, "id": c.id, "type": "function",
                     "function": {"name": c.name, "arguments": c.arguments}}
                    for i, c in enumerate(calls)]}, "tool_calls")
            else:
                yield emit({}, "stop")
            yield DONE
        return events()

    def _responses_body(self, body: dict) -> tuple[dict, list[int]]:
        from .responses import responses_to_chatcmpl
        try:
            chat_body = responses_to_chatcmpl(body)
        except ValueError as e:
            raise RequestError(400, str(e)) from e
        prompt = self._chat_prompt(chat_body.get("messages", []),
                                   tools=chat_body.get("tools"))
        return chat_body, self.rt.tokenizer.encode(prompt)

    @staticmethod
    def _calls(calls) -> list[dict]:
        return [{"id": c.id, "name": c.name, "arguments": c.arguments} for c in calls]

    def oai_responses(self, body: dict) -> dict:
        """POST /v1/responses — the OpenAI Responses API, run as a chat
        completion and rebuilt in the Responses shape."""
        from .responses import build_response, new_ids
        chat_body, ids_tok = self._responses_body(body)
        toks, text, _ = self._run(ids_tok, chat_body)
        reasoning, content, calls = self._parse_chat_output(text)
        return build_response(new_ids(), self.model_name, reasoning=reasoning,
                              content=content, tool_calls=self._calls(calls),
                              n_prompt=len(ids_tok), n_decoded=len(toks))

    def oai_responses_stream(self, body: dict, holder: dict | None = None) -> Iterator:
        from .responses import ResponsesStream, new_ids
        chat_body, ids_tok = self._responses_body(body)
        req, q = self._open(ids_tok, chat_body, holder)
        stream = ResponsesStream(new_ids(), self.model_name)

        def events():
            yield from stream.open_events()
            n, text = 0, ""
            for tok, piece, _ in self._pieces(req, q):
                n += tok >= 0
                text += piece
                if piece:
                    yield from stream.delta_events(piece)
            reasoning, content, calls = self._parse_chat_output(text)
            yield from stream.final_events(
                reasoning=reasoning, content=content, tool_calls=self._calls(calls),
                n_prompt=len(ids_tok), n_decoded=n)   # no [DONE] for this API
        return events()


GET_ROUTES = {"/health": "health", "/props": "props", "/v1/models": "models",
              "/models": "models", "/metrics": "metrics", "/slots": "slots",
              "/control-vectors": "cvec_list", "/lora-adapters": "lora_list"}
POST_ROUTES = {"/tokenize": "tokenize", "/detokenize": "detokenize",
               "/apply-template": "apply_template",
               "/completion": "completion", "/completions": "completion",
               "/v1/completions": "oai_completions",
               "/v1/chat/completions": "oai_chat", "/chat/completions": "oai_chat",
               "/v1/responses": "oai_responses", "/responses": "oai_responses",
               "/control-vectors/load": "cvec_load",
               "/control-vectors/unload": "cvec_unload",
               "/control-vectors/apply": "cvec_apply",
               "/lora-adapters": "lora_set",
               "/embedding": "embeddings", "/embeddings": "embeddings",
               "/v1/embeddings": "oai_embeddings", "/rerank": "rerank",
               "/v1/rerank": "rerank", "/infill": "infill"}


def sse(item) -> bytes:
    """One server-sent event: ``[DONE]``, a data line, or a named event."""
    if item == DONE:
        return b"data: [DONE]\n\n"
    head = f"event: {item['event']}\n" if item["event"] else ""
    return f"{head}data: {json.dumps(item['data'])}\n\n".encode()


def _aiohttp_web():
    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError("the HTTP server needs the aiohttp package; without "
                          "it, call ik_llama_cpp_tpu_torch.server.app.Server's "
                          "methods directly") from e
    return web


def make_app(srv: Server):
    """The aiohttp application: thin handlers over ``srv``'s methods. Each
    call that waits on the engine runs in the default executor."""
    import asyncio
    web = _aiohttp_web()
    cors = {"Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type, Authorization, x-api-key"}

    @web.middleware
    async def auth(request, handler):
        if request.method == "OPTIONS":
            return web.Response(status=204, headers=cors)
        # /health stays open (load-balancer probes), like the reference
        if srv.api_key and request.path != "/health":
            got = request.headers.get("Authorization", "")
            got = got.removeprefix("Bearer ").strip() or \
                request.headers.get("x-api-key", "")
            if got != srv.api_key:
                return web.json_response(
                    {"error": {"message": "invalid api key",
                               "type": "authentication_error"}},
                    status=401, headers=cors)
        resp = await handler(request)
        if not resp.prepared:
            resp.headers.update(cors)
        return resp

    async def get(request):
        out = getattr(srv, GET_ROUTES[request.path])()
        if isinstance(out, str):
            return web.Response(text=out, content_type="text/plain")
        bad = request.path == "/health" and out["status"] != "ok"
        return web.json_response(out, status=503 if bad else 200)

    async def post(request):
        body = await request.json()
        name = POST_ROUTES[request.path]
        loop = asyncio.get_running_loop()
        streamed = (isinstance(body, dict) and body.get("stream")
                    and hasattr(srv, name + "_stream"))
        holder: dict = {}
        try:
            if not streamed:
                out = await loop.run_in_executor(None, getattr(srv, name), body)
                return web.json_response(out)
            it = await loop.run_in_executor(
                None, getattr(srv, name + "_stream"), body, holder)
        except RequestError as e:
            return web.json_response(e.payload, status=e.status)
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream", **cors})
        await resp.prepare(request)
        end = object()
        try:
            while (item := await loop.run_in_executor(None, next, it, end)) is not end:
                await resp.write(sse(item))
        except RequestError as e:
            await resp.write(sse({"event": None, "data": e.payload}))
        except (asyncio.CancelledError, ConnectionResetError):
            # client disconnect: release the slot
            if holder.get("req") is not None:
                holder["req"].cancelled = True
            raise
        await resp.write_eof()
        return resp

    app = web.Application(middlewares=[auth])
    for path in GET_ROUTES:
        app.router.add_get(path, get)
    for path in POST_ROUTES:
        app.router.add_post(path, post)
    return app


def parse_args(argv=None) -> argparse.Namespace:
    """The server's command line."""
    ap = argparse.ArgumentParser(prog="ik_llama_cpp_tpu_torch.server")
    ap.add_argument("--gguf", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--spec",   # ngram | suffix | ngram-mod | ngram-cache | eagle3
                    help="self-speculation stage for the decode loop "
                         "(drafts verified in the shared batched step)")
    ap.add_argument("--spec-n", type=int, default=8,
                    help="draft tokens per speculative step")
    ap.add_argument("--ctx-size", type=int, default=2048)
    ap.add_argument("--cache-ram", "-cram", type=int, default=0,
                    help="RAM prompt-cache tier in MiB for evicted slot "
                         "states (0 = off, -1 = unlimited)")
    ap.add_argument("--cache-type", choices=["bf16", "q8", "q6", "q4", "iq4_nl"],
                    default="bf16", help="KV cache type (-ctk/-ctv analogue)")
    ap.add_argument("--api-key", help="require this key (Bearer or x-api-key)")
    ap.add_argument("--control-vector", action="append", default=[],
                    help="control-vector GGUF (repeatable); PATH or PATH:SCALE, "
                         "applied at startup")
    ap.add_argument("--lora", action="append", default=[],
                    help="LoRA adapter GGUF (repeatable); PATH or PATH:SCALE. "
                         "The model is then loaded with q/k/v and gate/up unfused")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the cache (cpu for tests)")
    return ap.parse_args(argv)


def parse_lora_arg(spec: str) -> tuple[str, float]:
    """``--lora PATH[:SCALE]`` -> (path, scale); the scale defaults to 1."""
    path, _, s = spec.rpartition(":")
    if path and s.replace(".", "").isdigit():
        return path, float(s)
    return spec, 1.0


def load_loras(rt: Runtime, specs: list[str]) -> list:
    """Load and apply each ``--lora`` adapter to ``rt.params``, in order."""
    from ..runtime.lora import apply_lora, load_lora_gguf
    loras = []
    for spec in specs:
        path, scale = parse_lora_arg(spec)
        adapter = load_lora_gguf(path)
        adapter.scale = scale
        apply_lora(rt.params, adapter)
        loras.append(adapter)
    return loras


def main(argv=None):
    args = parse_args(argv)
    web = _aiohttp_web()
    # per-projection adapters need the q/k/v and gate/up linears unfused
    rt = Runtime.from_gguf(args.gguf, args.device,
                           kv_quant=False if args.cache_type == "bf16" else args.cache_type,
                           fuse=not args.lora)
    loras = load_loras(rt, args.lora)
    engine = BatchEngine(rt, n_slots=args.parallel, capacity=args.ctx_size,
                         spec=args.spec, spec_n=args.spec_n,
                         cache_ram_mib=args.cache_ram)
    engine.start()
    srv = Server(engine, model_name=str(args.gguf), api_key=args.api_key)
    srv.loras = loras
    for spec in args.control_vector:
        path, _, scale = spec.rpartition(":")
        if not (path and scale.replace(".", "").replace("-", "").isdigit()):
            path, scale = spec, "1.0"
        srv.control_vectors.append({"path": path, "scale": float(scale), "layer_start": 1,
                                    "layer_end": rt.cfg.n_layer, "applied": False})
    if srv.control_vectors:
        srv._reapply_cvec()
    try:
        web.run_app(make_app(srv), host=args.host, port=args.port)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
