"""OpenAI Responses API (/v1/responses) support.

Pure conversion + output-builder functions, split from the HTTP layer so
they are unit-testable without booting a model:

* ``responses_to_chatcmpl`` — the request-side translation of a Responses
  body into a Chat-Completions body (the reference's
  ``server_chat_convert_responses_to_chatcmpl``,
  examples/server/server-chat.cpp:6).
* ``build_response`` — the final (non-streaming) ``"object": "response"``
  JSON (examples/server/server-task.cpp:473
  ``to_json_oaicompat_resp_final``).
* ``ResponsesStream`` — stateful SSE event generation for the streaming
  path: ``response.created`` → ``output_item.added`` /
  ``content_part.added`` → ``output_text.delta``\\* → done events →
  ``response.completed`` (server-task.cpp:236 partial + :544 stream-final
  builders; events are serialized ``event: <name>\\ndata: <json>\\n\\n``
  like server-common.cpp:522, with **no** trailing ``data: [DONE]`` —
  server.cpp:1250 excludes OAICOMPAT_TYPE_RESP from the DONE sentinel).
"""
from __future__ import annotations

import json
import time
import uuid


# ---------------------------------------------------------------- request

def _content_str(item) -> bool:
    return isinstance(item.get("content"), str)


def _as_parts(item: dict) -> list:
    """Normalize a string content field to a one-element input_text list."""
    c = item.get("content")
    if isinstance(c, str):
        return [{"type": "input_text", "text": c}]
    return c


def responses_to_chatcmpl(body: dict) -> dict:
    """Convert a Responses-API request body to a Chat-Completions body.

    Raises ValueError on malformed input (mapped to HTTP 400 by the
    caller), matching the reference's runtime_error messages.
    """
    if "input" not in body:
        raise ValueError("'input' is required")
    if body.get("previous_response_id"):
        raise ValueError("'previous_response_id' is not supported")

    inp = body["input"]
    out = {k: v for k, v in body.items() if k not in (
        "input", "instructions", "tools", "max_output_tokens", "reasoning",
        "store", "include", "prompt_cache_key", "client_metadata",
        "background", "max_tool_calls", "metadata")}
    messages: list[dict] = []

    if body.get("instructions") is not None:
        messages.append({"role": "system",
                         "content": str(body.get("instructions", ""))})

    if isinstance(inp, str):
        messages.append({"role": "user", "content": inp})
    elif isinstance(inp, list):
        for raw in inp:
            if not isinstance(raw, dict):
                raise ValueError("input items must be objects")
            item = dict(raw)
            role = item.get("role")
            typ = item.get("type")
            # assistant turns replayed as plain strings (valid per the
            # Responses API) pass through untouched — _as_parts would turn
            # them into input_text parts the assistant branch rejects
            if role == "assistant" and typ in (None, "message") \
                    and isinstance(item.get("content"), str):
                messages.append({"role": "assistant",
                                 "content": item["content"]})
                continue
            content = _as_parts(item)
            if isinstance(content, list) and role in (
                    "user", "system", "developer"):
                parts = []
                for p in content:
                    pt = p.get("type") if isinstance(p, dict) else None
                    if pt == "input_text":
                        if "text" not in p:
                            raise ValueError("'input_text' requires 'text'")
                        parts.append({"type": "text", "text": p["text"]})
                    elif pt == "input_image":
                        if "image_url" not in p:
                            raise ValueError("'image_url' is required")
                        parts.append({"type": "image_url",
                                      "image_url": {"url": p["image_url"]}})
                    elif pt == "input_file":
                        raise ValueError("'input_file' is not supported")
                    else:
                        raise ValueError(
                            "'type' must be one of 'input_text', "
                            "'input_image', or 'input_file'")
                item.pop("type", None)
                item.pop("status", None)
                item["content"] = parts
                messages.append(item)
            elif (isinstance(content, list) and role == "assistant"
                  and typ in (None, "message")):
                parts = []
                for p in content:
                    if not isinstance(p, dict) or \
                            p.get("type") != "output_text":
                        raise ValueError("'type' must be 'output_text'")
                    if not isinstance(p.get("text"), str):
                        raise ValueError("'output_text' requires 'text'")
                    parts.append({"type": "text", "text": p["text"]})
                item.pop("type", None)
                item.pop("status", None)
                item["content"] = parts
                messages.append(item)
            elif (typ == "function_call"
                  and isinstance(item.get("arguments"), str)
                  and isinstance(item.get("call_id"), str)
                  and isinstance(item.get("name"), str)):
                msg = {"role": "assistant", "tool_calls": [{
                    "id": item["call_id"], "type": "function",
                    "function": {"name": item["name"],
                                 "arguments": item["arguments"]}}]}
                # fold a preceding bare reasoning item into the tool call
                # message (reference pops the placeholder, server-chat.cpp:143)
                if messages and "reasoning_content" in messages[-1] \
                        and messages[-1].get("content") == []:
                    msg["reasoning_content"] = \
                        messages.pop()["reasoning_content"]
                messages.append(msg)
            elif (typ == "function_call_output"
                  and isinstance(item.get("call_id"), str)
                  and isinstance(item.get("output"), (str, list))):
                output = item["output"]
                if isinstance(output, list):
                    conv = []
                    for p in output:
                        if not isinstance(p, dict) or \
                                p.get("type") != "input_text":
                            raise ValueError(
                                "tool call output must be 'input_text'")
                        conv.append({**p, "type": "text"})
                    output = conv
                messages.append({"role": "tool",
                                 "tool_call_id": item["call_id"],
                                 "content": output})
            elif typ == "reasoning" and isinstance(item.get("summary"), list):
                c = item.get("content")
                if not isinstance(c, list) or not c or \
                        not isinstance(c[0], dict) or \
                        not isinstance(c[0].get("text"), str):
                    raise ValueError("reasoning item requires content[0].text")
                messages.append({"role": "assistant", "content": [],
                                 "reasoning_content": c[0]["text"]})
            else:
                raise ValueError("cannot determine type of input item")
    else:
        raise ValueError("'input' must be a string or array of objects")

    # drop unconsumed bare reasoning placeholders (server-chat.cpp:204)
    messages = [m for m in messages
                if not (m.get("role") == "assistant"
                        and m.get("content") == []
                        and "reasoning_content" in m)]
    out["messages"] = messages

    if "tools" in body:
        if not isinstance(body["tools"], list):
            raise ValueError("'tools' must be an array of objects")
        tools = []
        for t in body["tools"]:
            # Responses built-ins (web_search, image_generation, …) have no
            # chat-completions analogue; only function tools pass through
            if not isinstance(t, dict) or t.get("type") != "function":
                continue
            fn = {k: v for k, v in t.items() if k != "type"}
            fn.setdefault("strict", True)
            tools.append({"type": "function", "function": fn})
        if tools:
            out["tools"] = tools

    if "max_output_tokens" in body:
        out["max_tokens"] = body["max_output_tokens"]
    return out


# ----------------------------------------------------------------- output

def new_ids() -> dict:
    h = uuid.uuid4().hex
    return {"resp": f"resp_{h}", "msg": f"msg_{h[:24]}",
            "reasoning": f"rs_{h[:24]}"}


def _output_items(ids: dict, reasoning: str, content: str,
                  tool_calls: list[dict]) -> list[dict]:
    out = []
    if reasoning:
        out.append({"id": ids["reasoning"], "summary": [],
                    "type": "reasoning",
                    "content": [{"text": reasoning,
                                 "type": "reasoning_text"}],
                    "encrypted_content": "", "status": "completed"})
    if content:
        out.append({"content": [{"type": "output_text", "annotations": [],
                                 "logprobs": [], "text": content}],
                    "id": ids["msg"], "role": "assistant",
                    "status": "completed", "type": "message"})
    for tc in tool_calls:
        out.append({"type": "function_call", "status": "completed",
                    "arguments": tc.get("arguments", ""),
                    "call_id": "fc_" + tc.get("id", ""),
                    "name": tc.get("name", "")})
    return out


def build_response(ids: dict, model: str, *, reasoning: str = "",
                   content: str = "", tool_calls: list[dict] | None = None,
                   n_prompt: int = 0, n_decoded: int = 0,
                   cached: int = 0) -> dict:
    """Final non-streaming response object (to_json_oaicompat_resp_final)."""
    t = int(time.time())
    return {
        "completed_at": t, "created_at": t, "id": ids["resp"],
        "model": model, "object": "response",
        "output": _output_items(ids, reasoning, content, tool_calls or []),
        "status": "completed",
        "usage": {"input_tokens": n_prompt, "output_tokens": n_decoded,
                  "total_tokens": n_prompt + n_decoded,
                  "input_tokens_details": {"cached_tokens": cached}},
    }


def sse(event: dict) -> bytes:
    """Serialize one {'event','data'} pair the way the reference does
    (server-common.cpp:522) — note no [DONE] sentinel for this API."""
    return (f"event: {event['event']}\n"
            f"data: {json.dumps(event['data'])}\n\n").encode()


class ResponsesStream:
    """Incremental event builder for the streaming path.

    ``open_events()`` once, ``delta_events(piece)`` per decoded text piece,
    then ``final_events(...)`` with the parsed full message.
    """

    def __init__(self, ids: dict, model: str):
        self.ids = ids
        self.model = model
        self._text_started = False

    def open_events(self) -> list[dict]:
        resp = {"id": self.ids["resp"], "object": "response",
                "status": "in_progress"}
        return [
            {"event": "response.created",
             "data": {"type": "response.created", "response": resp}},
            {"event": "response.in_progress",
             "data": {"type": "response.in_progress", "response": resp}},
        ]

    def delta_events(self, piece: str) -> list[dict]:
        ev = []
        if not self._text_started:
            ev.append({"event": "response.output_item.added",
                       "data": {"type": "response.output_item.added",
                                "item": {"content": [], "id": self.ids["msg"],
                                         "role": "assistant",
                                         "status": "in_progress",
                                         "type": "message"}}})
            ev.append({"event": "response.content_part.added",
                       "data": {"type": "response.content_part.added",
                                "item_id": self.ids["msg"],
                                "part": {"type": "output_text", "text": ""}}})
            self._text_started = True
        ev.append({"event": "response.output_text.delta",
                   "data": {"type": "response.output_text.delta",
                            "item_id": self.ids["msg"], "delta": piece}})
        return ev

    def final_events(self, *, reasoning: str = "", content: str = "",
                     tool_calls: list[dict] | None = None,
                     n_prompt: int = 0, n_decoded: int = 0) -> list[dict]:
        """Done events + response.completed (to_json_oaicompat_resp_stream)."""
        ids = self.ids
        events: list[dict] = []
        output = _output_items(ids, reasoning, content, tool_calls or [])
        for item in output:
            if item["type"] == "message":
                events.append({"event": "response.output_text.done",
                               "data": {"type": "response.output_text.done",
                                        "item_id": ids["msg"],
                                        "text": content}})
                events.append({"event": "response.content_part.done",
                               "data": {"type": "response.content_part.done",
                                        "item_id": ids["msg"],
                                        "part": item["content"][0]}})
            events.append({"event": "response.output_item.done",
                           "data": {"type": "response.output_item.done",
                                    "item": item}})
        t = int(time.time())
        events.append({"event": "response.completed",
                       "data": {"type": "response.completed",
                                "response": {
                                    "id": ids["resp"], "object": "response",
                                    "created_at": t, "completed_at": t,
                                    "model": self.model, "output": output,
                                    "status": "completed",
                                    "usage": {
                                        "input_tokens": n_prompt,
                                        "output_tokens": n_decoded,
                                        "total_tokens": n_prompt + n_decoded,
                                    }}}})
        return events
