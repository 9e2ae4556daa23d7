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

Endpoints: /health /props /v1/props /version /v1/models /metrics /slots
/tokenize /detokenize /completion(s) /v1/completions /v1/chat/completions
/v1/responses /apply-template, Anthropic's /v1/messages and
/v1/messages/count_tokens, the embeddings routes /embedding, /embeddings
and /v1/embeddings (``Runtime.embed``: pooled, L2-normalized vectors),
/rerank and /v1/rerank (documents scored by the dot product of their
mean-pooled embeddings with the query's), /infill (a fill-in-the-middle
completion from the tokenizer's FIM tokens), the control vectors' GET
/control-vectors and POST /control-vectors/load, /unload and /apply, the
LoRA adapters' GET and POST /lora-adapters (adapters given with ``--lora
PATH[:SCALE]``, which loads the model with its q/k/v and gate/up unfused),
slot state (POST /slots/{id}?action=save|restore|erase, GET /slots/list;
the saved files in ``--slot-save-path``: GET /list, POST /delete_prompt
and /rename_prompt) and the session store of ``--sql-save-file`` (POST
/load /save /rename /all /delete, GET or POST /sessions, GET /vacuum). An
encoder-only model (the BERT family) serves the embeddings and rerank
routes and refuses generation with a 400.

The request options of the JAX server are all taken: grammars of every
kind (``grammar_kind`` regex / json / lark through ``runtime/llg.py``),
lazy grammars, banned strings and regexes, the reasoning budget,
``post_sampling_probs``, the allowlist (``--allowlist-*`` defaults, the
request's ``allowlist_*`` fields) and expiring logit biases. A forced
``tool_choice`` ("required" or a named function) constrains the output to
a call through ``json_schema.tool_call_gbnf``, in the call format the
chat template's analysis found (``runtime/chat_autoparser.py``; without
jinja2 the analysis is off, the call is bare JSON and the named parsers
read the output).

With ``--mmproj`` (a CLIP and/or whisper mmproj GGUF) a chat's
``image_url`` data URLs and ``input_audio`` parts are encoded and spliced
into the prompt (``runtime/mtmd.generate_mm``), run on the engine's loop
thread as a queued command. A PNG or a WAV needs no PIL
(``runtime/media.py``). POST /profiler/start and /profiler/stop record a
``torch.profiler`` trace of the served work into a Chrome trace file; GET /
serves the web UI.

Run: python -m ik_llama_cpp_tpu_torch.server --gguf model.gguf --port 8080
"""
from __future__ import annotations

import argparse
import json
import logging
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
# chat content parts of the multimodal path
MEDIA_PARTS = ("image_url", "input_image", "input_audio", "image")
IMAGE_MARKER, AUDIO_MARKER = "<__image__>", "<__audio__>"


class RequestError(Exception):
    """A request the server refuses (status 400) or failed (status 500)."""

    def __init__(self, status: int, message: str,
                 kind: str = "invalid_request_error", payload: dict | None = None):
        super().__init__(message)
        self.status = status
        # the body of the reply: OpenAI's error object unless a route has
        # its own form
        self.payload = payload or {"error": {"message": message, "type": kind}}


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


def _allowlist_fields(body: dict, srv) -> dict:
    """The allowlist's Request fields: the server's defaults, overridden by
    the request's ``allowlist_unicode_rules`` (a list of rulesets, each a
    list of rule strings), ``allowlist_keywords``, ``allowlist_piece_array``
    and ``allowlist_keyword_delay`` (server-context.cpp:1707-1717)."""
    rules = srv.allow_rules
    body_rules = body.get("allowlist_unicode_rules")
    if isinstance(body_rules, list):
        from ..runtime.allowlist import parse_rule
        rules = [[parse_rule(str(r)) for r in rs] for rs in body_rules if isinstance(rs, list)]
    kws = srv.allow_kws
    if isinstance(body.get("allowlist_keywords"), list):
        kws = [str(k) for k in body["allowlist_keywords"]]
    pieces = srv.allow_pieces
    if isinstance(body.get("allowlist_piece_array"), list):
        pieces = [str(x) for x in body["allowlist_piece_array"] if isinstance(x, str)]
    return {"allow_rules": rules, "allow_pieces": pieces, "allow_kws": kws,
            "allow_kw_delay": int(body.get("allowlist_keyword_delay", srv.allow_kw_delay))}


def _grammar_from(body: dict) -> str | None:
    """GBNF grammar text from the request: native ``grammar`` /
    ``json_schema`` fields (server.cpp params_from_json_cmpl) or the OpenAI
    ``response_format`` object (json_object / json_schema types). A
    ``grammar_kind`` of regex / json / lark goes through ``runtime/llg.py``
    to GBNF here, so every later path (lazy triggers, the allowlist) sees
    GBNF."""
    if body.get("grammar"):
        kind = str(body.get("grammar_kind") or "gbnf")
        if kind not in ("gbnf", "grammar"):
            from ..runtime.llg import to_gbnf
            return to_gbnf(kind, str(body["grammar"]))
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


def _safe_name(name) -> str | None:
    """The directory-traversal guard of the saved-prompt file routes
    (server.cpp delete_saved_prompt): a plain file name, else None."""
    if not isinstance(name, str) or not name or ".." in name or "/" in name or "\\" in name:
        return None
    return name


def _anthropic_flatten(messages: list[dict]) -> list[dict]:
    """Anthropic content blocks (text / tool_use / tool_result) flattened
    into plain-text chat messages for the template."""
    out = []
    for m in messages:
        c = m.get("content")
        if isinstance(c, str):
            out.append(m)
            continue
        parts = []
        for blk in c or []:
            t = blk.get("type")
            if t == "text":
                parts.append(blk.get("text", ""))
            elif t == "tool_use":
                call = json.dumps({"name": blk.get("name"), "arguments": blk.get("input", {})})
                parts.append(f"<tool_call>{call}</tool_call>")
            elif t == "tool_result":
                content = blk.get("content")
                if isinstance(content, list):
                    content = "".join(x.get("text", "") for x in content if isinstance(x, dict))
                parts.append(f"<tool_response>{content}</tool_response>")
        out.append({**m, "content": "\n".join(parts)})
    return out


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
        # the chat template's analysis (runtime/chat_autoparser.py): its
        # reasoning markers and tool-call format, for parsing and for a
        # forced tool call; None for a built-in template, or without jinja2
        self.chat_analysis = None
        if self.template and ("{{" in self.template or "{%" in self.template):
            try:
                from ..runtime.chat_autoparser import analyze_template
                self.chat_analysis = analyze_template(self.template)
            except Exception as e:          # noqa: BLE001 - the named parsers serve
                logging.getLogger("ik_llama_cpp_tpu_torch").warning(
                    "chat template analysis is off (%s: %s): the named parsers read "
                    "the output", type(e).__name__, e)
        # allowlist defaults (--allowlist-unicode-rule / -pieces / -keyword
        # / -keyword-delay) and the expiring-logit-bias rule text
        # (--expiring-logit-bias-file); request fields override them
        self.allow_rules: list = []
        self.allow_pieces: list = []
        self.allow_kws: list = []
        self.allow_kw_delay = 0
        self.expiring_logit_bias = None
        self.slot_save_path = "."       # --slot-save-path
        self.session_db = None          # sessions.SessionDB under --sql-save-file
        self.clip = None                # models/clip.ClipEncoder under --mmproj
        self.audio = None               # models/clip.AudioEncoder when the mmproj has one
        self._profile = None            # (torch.profiler.profile, dir) while one runs

    # ------------------------------------------------------ engine bridge
    def _open(self, prompt_ids: list[int], body: dict,
              holder: dict | None = None) -> tuple[Request, queue.Queue]:
        """Validate the body, build the engine Request and submit it."""
        from ..runtime.grammar import GBNFParseError, Grammar
        try:
            g_text = _grammar_from(body)
            if g_text is not None:
                Grammar(g_text)     # validate before admitting -> clean 400
            allow = _allowlist_fields(body, self)
        except (GBNFParseError, ValueError, KeyError, IndexError) as e:
            raise RequestError(400, f"invalid grammar/schema/rule: {e!r}") from e
        q: queue.Queue = queue.Queue()
        req = Request(
            prompt_ids=list(prompt_ids),
            n_predict=int(body.get("n_predict", body.get("max_tokens", 128))),
            sampler=_sampler_from(body, tok=self.rt.tokenizer),
            seed=int(body.get("seed", int(time.time() * 1000) % 2**31)),
            stop=body.get("stop", []) or [],
            grammar=g_text,
            grammar_lazy=bool(body.get("grammar_lazy", False)),
            grammar_triggers=[t.get("value", "") if isinstance(t, dict) else str(t)
                              for t in body.get("grammar_triggers") or []],
            n_probs=_n_probs_from(body),
            post_sampling_probs=bool(body.get("post_sampling_probs", False)),
            n_keep=int(body.get("n_keep", -1)),
            n_discard=int(body.get("n_discard", -1)),
            cache_prompt=bool(body.get("cache_prompt", True)),
            banned_strings=[str(x).lower() for x in body.get("banned_strings") or [] if x],
            banned_regex=[str(x) for x in body.get("banned_regex") or [] if x],
            banned_regex_ci=[str(x) for x in body.get("banned_regex_ci") or [] if x],
            banned_bias=float(body.get("banned_bias", -999.0)),
            banned_n=int(body.get("banned_n", 1)),
            banbuffer=int(body.get("banbuffer_size", 0)),
            rewind_count_max=int(body.get("rewind_count_max", -1)),
            saturate_predict=bool(body.get("saturate_predict", False)),
            reasoning_budget=int(body.get(
                "reasoning_budget", body.get("reasoning_budget_tokens", -1))),
            reasoning_start_tag=str(body.get("reasoning_budget_start_tag") or "<think>"),
            reasoning_end_tag=str(body.get("reasoning_budget_end_tag") or "</think>"),
            reasoning_message=str(body.get("reasoning_budget_message") or "\n"),
            expiring_logit_bias=body.get("expiring_logit_bias", self.expiring_logit_bias),
            stream_queue=q,
            **allow,
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
        self._refuse_media(messages)
        return apply_chat_template(messages, template=self.template, tools=tools,
                                   add_generation_prompt=True)

    @staticmethod
    def _refuse_media(messages: list, why: str = "") -> None:
        """Media parts left in a prompt are a 400: without ``--mmproj`` (the
        JAX server templates them as text), or where the route takes none."""
        for m in messages:
            parts = m.get("content") if isinstance(m, dict) else None
            if isinstance(parts, list) and any(
                    isinstance(x, dict) and x.get("type") in MEDIA_PARTS for x in parts):
                raise RequestError(400, why or "image and audio input needs a multimodal "
                                   "projector: start the server with --mmproj")

    def _extract_images(self, messages: list[dict]) -> tuple[list, list]:
        """Replace image_url / input_audio content parts with <__image__> /
        <__audio__> markers; returns (messages, decoded media in marker
        order): (H, W, 3) uint8 arrays for base64 data-URL images (a PNG
        with no PIL, any other format through PIL) and float32 16 kHz
        samples for base64 WAV (PCM16, OpenAI's input_audio format)."""
        import base64
        import struct
        import wave
        import zlib
        from ..runtime.media import decode_image, decode_wav
        bad_media = (ValueError, EOFError, OSError, struct.error, wave.Error, zlib.error)
        media, out_msgs = [], []
        for m in messages:
            c = m.get("content")
            if not isinstance(c, list):
                out_msgs.append(m)
                continue
            text_parts = []
            for part in c:
                if not isinstance(part, dict):
                    continue
                try:
                    if part.get("type") == "image_url":
                        url = part.get("image_url", {})
                        url = url.get("url", url) if isinstance(url, dict) else url
                        if isinstance(url, str) and url.startswith("data:"):
                            media.append(decode_image(base64.b64decode(url.split(",", 1)[1])))
                            text_parts.append(IMAGE_MARKER)
                    elif part.get("type") == "input_audio":
                        spec = part.get("input_audio", {})
                        media.append(decode_wav(base64.b64decode(spec.get("data", ""))))
                        text_parts.append(AUDIO_MARKER)
                    else:
                        text_parts.append(part.get("text", ""))
                except bad_media as e:
                    raise RequestError(400, f"{part.get('type')}: {e}") from e
            out_msgs.append({**m, "content": "".join(text_parts)})
        return out_msgs, media

    def _media(self, body: dict) -> tuple[list, list]:
        """(messages, media) of a chat body: the media parts extracted when
        an mmproj is loaded, else the messages as they are."""
        messages = body.get("messages", [])
        if self.clip is None and self.audio is None:
            return messages, []
        return self._extract_images(messages)

    def _chat_multimodal(self, body: dict, messages: list, media: list) -> tuple:
        """A media-bearing chat through the mtmd path (encode, splice,
        prefill by rows, decode), run on the engine's loop thread between
        two steps: (prompt rows, generated ids, text)."""
        from ..runtime.mtmd import generate_mm
        prompt = self._chat_prompt(messages)
        sampler = _sampler_from(body, self.rt.tokenizer)
        n_predict = int(body.get("n_predict", body.get("max_tokens", 128)))
        n_prompt, out = self.engine._call(lambda: generate_mm(
            self.rt, prompt, media, self.clip, audio_encoder=self.audio,
            max_new_tokens=n_predict, sampler=sampler, seed=int(body.get("seed", 0)),
            capacity=self.engine.capacity))
        eos = self.rt.tokenizer.eos_id
        return n_prompt, out, self.rt.tokenizer.decode([t for t in out if t != eos])

    def _mm_message(self, text: str) -> dict:
        reasoning, content = split_reasoning(text)
        message = {"role": "assistant", "content": content}
        if reasoning:
            message["reasoning_content"] = reasoning
        return message

    def profiler_start(self, body: dict | None = None) -> dict:
        """POST /profiler/start {"dir"?}: a ``torch.profiler`` capture of the
        live serving work, written at stop as a Chrome trace into ``dir``
        (default ``ik_torch_trace`` under the working directory). It starts
        and stops on the engine's loop thread, which launches the serving
        work: its host ops and, on the card, every kernel are recorded (a
        capture must start and stop on one thread; the HTTP layer runs each
        request on a pool thread). The JAX routes' errors and status codes:
        a second start, or a stop with none running, is a 400."""
        if self._profile is not None:
            raise RequestError(400, "profiler already running", payload={
                "success": False, "error": "profiler already running",
                "dir": self._profile[1]})
        logdir = (body or {}).get("dir") or "ik_torch_trace"
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.rt.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            self.engine._call(prof.start)
        except Exception as e:          # noqa: BLE001 - the reply names it
            raise RequestError(400, str(e), payload={"success": False, "error": str(e)}) from e
        self._profile = (prof, logdir)
        return {"success": True, "dir": logdir}

    def profiler_stop(self, body: dict | None = None) -> dict:
        """POST /profiler/stop: the capture written as ``dir/trace-<ms>.json``."""
        if self._profile is None:
            raise RequestError(400, "profiler not running", payload={
                "success": False, "error": "profiler not running"})
        (prof, logdir), self._profile = self._profile, None
        try:
            self.engine._call(prof.stop)
            Path(logdir).mkdir(parents=True, exist_ok=True)
            trace = Path(logdir) / f"trace-{int(time.time() * 1000)}.json"
            prof.export_chrome_trace(str(trace))
        except Exception as e:          # noqa: BLE001 - the reply names it
            raise RequestError(400, str(e), payload={"success": False, "error": str(e)}) from e
        return {"success": True, "dir": logdir, "trace": str(trace)}

    def webui(self) -> str:
        """GET /: the built-in web UI (the port's copy of the JAX server's
        ``webui.html``)."""
        return (Path(__file__).parent / "webui.html").read_text()

    def _dec(self, t) -> str:
        return self.rt.tokenizer.decode([int(t)])

    def _parse_chat_output(self, text: str):
        """(reasoning, content, tool calls) of a chat completion's text: the
        template analysis's parser first, the named parsers when it finds
        neither reasoning nor a call, or when there is no analysis."""
        ca = self.chat_analysis
        if ca is not None and (ca.has_tools() or ca.reasoning_open):
            from ..runtime.chat_autoparser import parse_auto
            reasoning, content, calls = parse_auto(text, ca)
            if calls or reasoning:
                return reasoning, content, calls
        reasoning, content = split_reasoning(text)
        content, calls = parse_tool_calls(content)
        return reasoning, content, calls

    @staticmethod
    def _apply_tool_choice(body: dict, analysis=None) -> dict:
        """tool_choice 'none' hides the tools; 'required' or a named
        function forces a schema-valid call through a grammar over the
        call format of the template's ``analysis`` (bare JSON without one;
        the reference's tool-call grammars, common/chat.cpp). A schema the
        converter cannot take leaves the output free."""
        tc = body.get("tool_choice")
        if not body.get("tools") or _grammar_from(body) is not None:
            return body
        if tc == "none":
            return {**body, "tools": None}
        sel = None
        if tc == "required":
            sel = body["tools"]
        elif isinstance(tc, dict) and tc.get("type") == "function":
            want = (tc.get("function") or {}).get("name")
            sel = [t for t in body["tools"] if (t.get("function") or {}).get("name") == want]
        if not sel:
            return body
        from ..runtime.json_schema import tool_call_gbnf
        calls = analysis is not None and analysis.has_tools()
        try:
            g = tool_call_gbnf(sel, open_tag=analysis.call_lead if calls else "",
                               close_tag=analysis.call_trail if calls else "")
        except Exception:       # noqa: BLE001 - an unconvertible schema: free form
            return body
        return {**body, "grammar": g}

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
            "modalities": self._modalities(),
        }

    def _modalities(self) -> dict:
        return {"vision": self.clip is not None, "audio": self.audio is not None}

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
        return RequestError(400, message, payload={"success": False, "error": message})

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
        body = self._apply_tool_choice(body, self.chat_analysis)
        prompt = self._chat_prompt(body.get("messages", []), tools=body.get("tools"))
        return body, self.rt.tokenizer.encode(prompt)

    def oai_chat(self, body: dict) -> dict:
        messages, media = self._media(body)
        if media:
            n_prompt, out, text = self._chat_multimodal(body, messages, media)
            return _chunk(f"chatcmpl-{uuid.uuid4().hex[:12]}", "chat.completion",
                          self.model_name, [{"index": 0, "message": self._mm_message(text),
                                             "finish_reason": "stop"}],
                          usage={"prompt_tokens": n_prompt, "completion_tokens": len(out),
                                 "total_tokens": n_prompt + len(out)})
        body, ids = self._chat_ids({**body, "messages": messages})
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
        messages, media = self._media(body)
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        if media:
            # the mtmd path decodes on the loop thread in one command: the
            # whole reply is one delta
            _, _, text = self._chat_multimodal(body, messages, media)
            message = self._mm_message(text)
            del message["role"]
            return iter([{"event": None, "data": _chunk(
                rid, "chat.completion.chunk", self.model_name,
                [{"index": 0, "delta": message, "finish_reason": "stop"}])}, DONE])
        body, ids = self._chat_ids({**body, "messages": messages})
        req, q = self._open(ids, body, holder)
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
        if self._media(chat_body)[1]:
            raise RequestError(400, "input_image is not supported on /v1/responses yet; "
                               "use /v1/chat/completions")
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


    # ------------------------------------------------------- slot state
    def version(self) -> dict:
        """GET /version (server.cpp:1921): the API version and the optional
        features (the session store keeps plain text: no zstd)."""
        return {"version": 4, "features": {"sql": self.session_db is not None,
                                           "zstd_compression": False}}

    def props_simple(self) -> dict:
        """GET /v1/props (server.cpp:1068 handle_props_simple): the model and
        the slot with the most cached tokens."""
        n_past, slot_id = 0, 0
        for i, s in enumerate(self.engine.slots):
            if len(s.cache_tokens) > n_past:
                n_past, slot_id = len(s.cache_tokens), i
        return {"model_name": Path(self.model_name).stem, "model_path": self.model_name,
                "modalities": self._modalities(),
                "n_past": n_past, "slot_id": slot_id}

    def slots_list(self) -> list:
        """GET /slots/list (server.cpp list_slot_prompts): each slot's
        cached prompt."""
        return [{"slot_id": s.idx, "token_count": len(s.cache_tokens),
                 "prompt": self.rt.tokenizer.decode(list(s.cache_tokens))}
                for s in self.engine.slots]

    def saved_prompts_list(self) -> list:
        """GET /list (server.cpp list_saved_prompts): the state files in the
        slot save path, each with its cached prompt's text."""
        from ..runtime.state import read_state_meta
        out = []
        try:
            for f in sorted(Path(self.slot_save_path).iterdir()):
                meta = read_state_meta(f) if f.is_file() else None
                if meta is None:
                    continue
                st = f.stat()
                toks = meta.get("tokens", [])
                out.append({"filename": f.name, "filesize": st.st_size,
                            "mtime": time.strftime("%Y-%m-%d %H:%M:%S",
                                                   time.localtime(st.st_mtime)),
                            "token_count": len(toks),
                            "prompt": self.rt.tokenizer.decode(toks)})
        except OSError as e:
            raise RequestError(500, str(e), "server_error") from e
        return out

    @staticmethod
    def _file_error(status: int, message: str) -> RequestError:
        return RequestError(status, message, payload={"error": message})

    def delete_prompt(self, body: dict) -> dict:
        """POST /delete_prompt {"filename"} (server.cpp:1807)."""
        name = _safe_name(body.get("filename"))
        if name is None:
            raise self._file_error(400, "Invalid filename format.")
        f = Path(self.slot_save_path) / name
        if not f.is_file():
            raise self._file_error(404, "File not found.")
        f.unlink()
        return {"status": "deleted", "filename": name}

    def rename_prompt(self, body: dict) -> dict:
        """POST /rename_prompt {"old_filename", "new_filename"}."""
        old, new = _safe_name(body.get("old_filename")), _safe_name(body.get("new_filename"))
        if old is None or new is None:
            raise self._file_error(400, "Invalid filename format.")
        src = Path(self.slot_save_path) / old
        if not src.is_file():
            raise self._file_error(404, "File not found.")
        src.rename(Path(self.slot_save_path) / new)
        return {"status": "renamed", "filename": new}

    def slot_action(self, idx: int, action: str, body: dict | None = None) -> dict:
        """POST /slots/{id}?action=save|restore|erase (server.cpp:2162). The
        file is ``body["filename"]`` (default ``slot<id>.bin``) in the slot
        save path; the engine runs the action on its loop thread. A busy
        slot's restore, a file that is no state of this cache, and a bad id
        or action are 400s; a missing file is a 404."""
        body = body or {}
        if not 0 <= idx < self.engine.n_slots:
            raise self._file_error(400, "invalid slot id")
        if action == "erase":
            return self.engine.erase_slot(idx)
        if action not in ("save", "restore"):
            raise self._file_error(400, "unknown action")
        name = _safe_name(body.get("filename", f"slot{idx}.bin"))
        if name is None:
            raise self._file_error(400, "Invalid filename format.")
        path = str(Path(self.slot_save_path) / name)
        if action == "restore" and not Path(path).is_file():
            raise self._file_error(404, "File not found.")
        try:
            if action == "save":
                return self.engine.save_slot(idx, path)
            return self.engine.restore_slot(idx, path)
        except (ValueError, TypeError) as e:
            raise self._file_error(400, str(e)) from e

    # ---------------------------------------------------- session store
    def _db(self):
        if self.session_db is None:
            msg = "session store disabled; start the server with --sql-save-file"
            raise RequestError(500, msg, payload={"ok": False, "message": msg})
        return self.session_db

    def db_load(self, body: dict) -> dict:
        """POST /load {"storeName", "key"} (server.cpp:1987)."""
        data = self._db().load(body.get("storeName"), body.get("key"))
        if data is None:
            raise RequestError(404, "Key not found",
                               payload={"ok": False, "message": "Key not found"})
        return {"ok": True, "result": data}

    def db_save(self, body: dict) -> dict:
        """POST /save {"storeName", "key", "data"}."""
        self._db().save(body.get("storeName"), body.get("key"), body.get("data"))
        return {"ok": True, "result": "Data saved successfully"}

    def db_rename(self, body: dict) -> dict:
        """POST /rename {"key", "newName"}."""
        self._db().rename(body.get("key"), str(body.get("newName", "")))
        return {"ok": True, "result": "Session renamed successfully"}

    def db_all(self, body: dict) -> dict:
        """POST /all {"storeName"}: every document of a store."""
        return {"ok": True, "result": self._db().all(body.get("storeName"))}

    def db_sessions(self, body: dict | None = None) -> dict:
        """GET or POST /sessions: {key: display name}."""
        return {"ok": True, "result": self._db().sessions()}

    def db_delete(self, body: dict) -> dict:
        """POST /delete {"storeName", "key"}."""
        self._db().delete(body.get("storeName"), body.get("key"))
        return {"ok": True, "result": "Session deleted successfully"}

    def db_vacuum(self) -> dict:
        self._db().vacuum()
        return {"ok": True}

    # ----------------------------------------------------- Anthropic API
    def _anthropic_body(self, body: dict) -> tuple[dict, list[int]]:
        """An Anthropic Messages body as the engine's body and prompt ids:
        content blocks flattened, the system prompt first, tools in the
        OpenAI shape, and tool_choice "any" / "tool" mapped onto the forced
        call ("required" / a named function)."""
        # the JAX server drops image blocks without a word (_anthropic_flatten)
        self._refuse_media(body.get("messages", []), "image blocks are not supported on "
                           "/v1/messages; use /v1/chat/completions with --mmproj")
        messages = _anthropic_flatten(body.get("messages", []))
        if body.get("system"):
            sys_c = body["system"]
            if isinstance(sys_c, list):
                sys_c = "".join(x.get("text", "") for x in sys_c if isinstance(x, dict))
            messages = [{"role": "system", "content": sys_c}] + messages
        tools = None
        if body.get("tools"):
            tools = [{"type": "function",
                      "function": {"name": t.get("name"),
                                   "description": t.get("description", ""),
                                   "parameters": t.get("input_schema", {})}}
                     for t in body["tools"]]
            atc = body.get("tool_choice")
            if isinstance(atc, dict) and atc.get("type") in ("any", "tool"):
                oai_tc = ("required" if atc["type"] == "any" else
                          {"type": "function", "function": {"name": atc.get("name")}})
                body = self._apply_tool_choice({**body, "tools": tools, "tool_choice": oai_tc},
                                               self.chat_analysis)
        ids = self.rt.tokenizer.encode(self._chat_prompt(messages, tools=tools))
        return {**body, "max_tokens": body.get("max_tokens", 128)}, ids

    def anthropic_messages(self, body: dict) -> dict:
        """POST /v1/messages: an Anthropic Messages response (thinking,
        text and tool_use blocks)."""
        body, ids = self._anthropic_body(body)
        toks, text, _ = self._run(ids, body)
        reasoning, content_text = split_reasoning(text)
        content_text, calls = parse_tool_calls(content_text)
        content = []
        if reasoning:
            content.append({"type": "thinking", "thinking": reasoning})
        if content_text:
            content.append({"type": "text", "text": content_text})
        for c in calls:
            content.append({"type": "tool_use", "id": "toolu_" + uuid.uuid4().hex[:16],
                            "name": c.name, "input": json.loads(c.arguments or "{}")})
        return {"id": f"msg_{uuid.uuid4().hex[:16]}", "type": "message", "role": "assistant",
                "content": content or [{"type": "text", "text": ""}],
                "model": self.model_name,
                "stop_reason": "tool_use" if calls else "end_turn",
                "usage": {"input_tokens": len(ids), "output_tokens": len(toks)}}

    def anthropic_messages_stream(self, body: dict, holder: dict | None = None) -> Iterator:
        """The streamed form: message_start, one text block of
        content_block_delta events, message_delta and message_stop."""
        body, ids = self._anthropic_body(body)
        req, q = self._open(ids, body, holder)
        rid = f"msg_{uuid.uuid4().hex[:16]}"

        def ev(name, data):
            return {"event": name, "data": {"type": name, **data}}

        def events():
            yield ev("message_start", {"message": {
                "id": rid, "type": "message", "role": "assistant", "content": [],
                "model": self.model_name,
                "usage": {"input_tokens": len(ids), "output_tokens": 0}}})
            yield ev("content_block_start", {"index": 0,
                                             "content_block": {"type": "text", "text": ""}})
            n = 0
            for tok, piece, _ in self._pieces(req, q):
                n += tok >= 0
                if piece:
                    yield ev("content_block_delta", {
                        "index": 0, "delta": {"type": "text_delta", "text": piece}})
            yield ev("content_block_stop", {"index": 0})
            yield ev("message_delta", {"delta": {"stop_reason": "end_turn"},
                                       "usage": {"output_tokens": n}})
            yield ev("message_stop", {})
        return events()

    def anthropic_count_tokens(self, body: dict) -> dict:
        """POST /v1/messages/count_tokens: the rendered prompt's tokens."""
        messages = body.get("messages", [])
        if body.get("system"):
            messages = [{"role": "system", "content": body["system"]}] + messages
        return {"input_tokens": len(self.rt.tokenizer.encode(self._chat_prompt(messages)))}


GET_ROUTES = {"/health": "health", "/props": "props", "/v1/models": "models",
              "/models": "models", "/metrics": "metrics", "/slots": "slots",
              "/control-vectors": "cvec_list", "/lora-adapters": "lora_list",
              "/version": "version", "/v1/props": "props_simple",
              "/slots/list": "slots_list", "/list": "saved_prompts_list",
              "/sessions": "db_sessions", "/vacuum": "db_vacuum", "/": "webui"}
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
               "/v1/rerank": "rerank", "/infill": "infill",
               "/v1/messages": "anthropic_messages",
               "/v1/messages/count_tokens": "anthropic_count_tokens",
               "/delete_prompt": "delete_prompt", "/rename_prompt": "rename_prompt",
               "/load": "db_load", "/save": "db_save", "/rename": "db_rename",
               "/all": "db_all", "/sessions": "db_sessions", "/delete": "db_delete",
               "/profiler/start": "profiler_start", "/profiler/stop": "profiler_stop"}


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
        try:
            out = getattr(srv, GET_ROUTES[request.path])()
        except RequestError as e:
            return web.json_response(e.payload, status=e.status)
        if isinstance(out, str):
            kind = "text/html" if request.path == "/" else "text/plain"
            return web.Response(text=out, content_type=kind)
        bad = request.path == "/health" and out["status"] != "ok"
        return web.json_response(out, status=503 if bad else 200)

    async def slot(request):
        """POST /slots/{id}?action=...: the engine runs it between two steps."""
        try:
            idx = int(request.match_info["id"])
        except ValueError:
            return web.json_response({"error": "invalid slot id"}, status=400)
        body = await request.json() if request.can_read_body else {}
        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, srv.slot_action, idx, request.query.get("action", ""), body)
        except RequestError as e:
            return web.json_response(e.payload, status=e.status)
        return web.json_response(out)

    async def post(request):
        body = await request.json() if request.can_read_body else {}
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
    app.router.add_post("/slots/{id}", slot)
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
    ap.add_argument("--mmproj", help="multimodal projector GGUF (CLIP and/or whisper) for "
                                     "image and audio input")
    ap.add_argument("--swa-compress", action="store_true",
                    help="ring caches on the sliding-window layers (bf16 cache)")
    ap.add_argument("--slot-save-path", default=".",
                    help="directory of the slot save/restore state files")
    ap.add_argument("--sql-save-file",
                    help="sqlite file of the session store (/load /save /sessions ...)")

    class _AllowAction(argparse.Action):
        # --allowlist-unicode-rule appends to the current ruleset and
        # --allowlist-keyword closes it, so the flags' order counts
        # (common.cpp:2327-2345)
        def __call__(self, parser, ns, values, option_string=None):
            seq = list(getattr(ns, "allow_seq", None) or [])
            seq.append(("kw" if "keyword" in option_string else "rule", values))
            ns.allow_seq = seq
    ap.add_argument("--allowlist-unicode-rule", action=_AllowAction, dest="allow_seq",
                    metavar="LOWER..UPPER,SCRIPT:BIAS",
                    help="allowlist rule (repeatable): a token with a code point "
                         "outside every rule is banned; the rules between two "
                         "--allowlist-keyword flags form one ruleset")
    ap.add_argument("--allowlist-keyword", action=_AllowAction, dest="allow_seq",
                    help="a keyword of the generated text that expires the current "
                         "ruleset and starts the next")
    ap.add_argument("--allowlist-pieces", action="append", default=[],
                    help="an always-allowed text piece (repeatable)")
    ap.add_argument("--allowlist-keyword-delay", type=int, default=0,
                    help="decoded tokens before keyword matching starts")
    ap.add_argument("--expiring-logit-bias-file",
                    help="expiring-logit-bias rule file; a request's "
                         "expiring_logit_bias field overrides it")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the cache (cpu for tests)")
    return ap.parse_args(argv)


def allowlist_defaults(seq) -> tuple[list, list]:
    """The (rulesets, keywords) of the --allowlist-unicode-rule /
    --allowlist-keyword flags, in their order."""
    from ..runtime.allowlist import parse_rule
    rulesets: list[list] = []
    kws: list[str] = []
    for kind, val in seq or []:
        if kind == "rule":
            if not rulesets:
                rulesets.append([])
            rulesets[-1].append(parse_rule(val))
        else:
            kws.append(val)
            rulesets.append([])
    return rulesets, kws


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


def load_mmproj(srv: Server, path: str) -> None:
    """Load ``--mmproj``'s vision and/or audio tower onto the model's device,
    as its ``clip.has_vision_encoder`` / ``clip.has_audio_encoder`` say."""
    from ..gguf.reader import load_gguf
    from ..models.clip import AudioEncoder, ClipEncoder
    md = load_gguf(path).metadata
    if md.get("clip.has_vision_encoder"):
        srv.clip = ClipEncoder(path, srv.rt.device)
    if md.get("clip.has_audio_encoder"):
        srv.audio = AudioEncoder(path, srv.rt.device)


def main(argv=None):
    args = parse_args(argv)
    web = _aiohttp_web()
    # per-projection adapters need the q/k/v and gate/up linears unfused
    rt = Runtime.from_gguf(args.gguf, args.device,
                           kv_quant=False if args.cache_type == "bf16" else args.cache_type,
                           fuse=not args.lora, swa_compress=args.swa_compress)
    loras = load_loras(rt, args.lora)
    engine = BatchEngine(rt, n_slots=args.parallel, capacity=args.ctx_size,
                         spec=args.spec, spec_n=args.spec_n,
                         cache_ram_mib=args.cache_ram)
    engine.start()
    srv = Server(engine, model_name=str(args.gguf), api_key=args.api_key)
    srv.loras = loras
    srv.allow_rules, srv.allow_kws = allowlist_defaults(getattr(args, "allow_seq", None))
    srv.allow_pieces = list(args.allowlist_pieces)
    srv.allow_kw_delay = args.allowlist_keyword_delay
    if args.expiring_logit_bias_file:
        srv.expiring_logit_bias = Path(args.expiring_logit_bias_file).read_text()
    srv.slot_save_path = args.slot_save_path
    if args.sql_save_file:
        from .sessions import SessionDB
        srv.session_db = SessionDB(args.sql_save_file)
    for spec in args.control_vector:
        path, _, scale = spec.rpartition(":")
        if not (path and scale.replace(".", "").replace("-", "").isdigit()):
            path, scale = spec, "1.0"
        srv.control_vectors.append({"path": path, "scale": float(scale), "layer_start": 1,
                                    "layer_end": rt.cfg.n_layer, "applied": False})
    if srv.control_vectors:
        srv._reapply_cvec()
    if args.mmproj:
        load_mmproj(srv, args.mmproj)
    try:
        web.run_app(make_app(srv), host=args.host, port=args.port)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
