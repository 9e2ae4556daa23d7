"""Chat templating + tool-call parsing — analogue of common/chat.cpp,
common/jinja/ and the server's model-specific tool-format parsers
(examples/server/{qwen3,kimi_k2,deepseek_r1}_tools.hpp).

Templates come from GGUF ``tokenizer.chat_template`` metadata rendered with
jinja2 (the reference vendors a C++ jinja engine; Python has the real one),
with named fallbacks for the common families (chatml, llama2, llama3, gemma,
mistral, zephyr, phi3, deepseek) like llama_chat_apply_template
(src/llama.cpp) supports.

Tool calls: ``parse_tool_calls`` recognizes the common output wire formats —
Hermes/Qwen ``<tool_call>{json}</tool_call>``, Mistral ``[TOOL_CALLS][...]``,
Llama-3.1 JSON (``{"name": ..., "parameters": ...}``) and functionary-style
``<function=name>{args}</function>`` — and returns OpenAI tool_call dicts.
Reasoning extraction splits ``<think>...</think>`` blocks (deepseek-r1/qwen3).
"""
from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field


# --------------------------------------------------------------------------
# named fallback templates (rendered without jinja)

def _chatml(messages, add_gen):
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m.get('content', '')}<|im_end|>\n")
    if add_gen:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _llama3(messages, add_gen):
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                   f"{m.get('content', '')}<|eot_id|>")
    if add_gen:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _llama2(messages, add_gen):
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m.get("content", "")
        elif m["role"] == "user":
            c = m.get("content", "")
            if system:
                c = f"<<SYS>>\n{system}\n<</SYS>>\n\n{c}"
                system = ""
            out.append(f"[INST] {c} [/INST]")
        else:
            out.append(f" {m.get('content', '')} ")
    return "".join(out)


def _gemma(messages, add_gen):
    out = []
    for m in messages:
        role = "model" if m["role"] == "assistant" else m["role"]
        if role == "system":       # gemma folds system into the first user turn
            role = "user"
        out.append(f"<start_of_turn>{role}\n{m.get('content', '')}<end_of_turn>\n")
    if add_gen:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _mistral(messages, add_gen):
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"[INST] {m.get('content', '')} [/INST]")
        elif m["role"] == "assistant":
            out.append(f"{m.get('content', '')}</s>")
        else:
            out.append(f"[INST] {m.get('content', '')} [/INST]")
    return "".join(out)


def _zephyr(messages, add_gen):
    out = [f"<|{m['role']}|>\n{m.get('content', '')}</s>\n" for m in messages]
    if add_gen:
        out.append("<|assistant|>\n")
    return "".join(out)


def _phi3(messages, add_gen):
    out = [f"<|{m['role']}|>\n{m.get('content', '')}<|end|>\n" for m in messages]
    if add_gen:
        out.append("<|assistant|>\n")
    return "".join(out)


def _deepseek(messages, add_gen):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m.get('content', '')}\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m.get('content', '')}\n\n")
        else:
            out.append(f"Assistant: {m.get('content', '')}<｜end▁of▁sentence｜>")
    if add_gen:
        out.append("Assistant:")
    return "".join(out)


FALLBACK_TEMPLATES = {
    "chatml": _chatml,
    "llama2": _llama2,
    "llama3": _llama3,
    "gemma": _gemma,
    "mistral": _mistral,
    "zephyr": _zephyr,
    "phi3": _phi3,
    "deepseek": _deepseek,
}


def detect_template_name(jinja_src: str | None) -> str:
    """Heuristic family detection from the jinja source — the analogue of
    llm_chat_detect_template (src/llama.cpp)."""
    if not jinja_src:
        return "chatml"
    s = jinja_src
    if "<|im_start|>" in s:
        return "chatml"
    if "<|start_header_id|>" in s:
        return "llama3"
    if "<start_of_turn>" in s:
        return "gemma"
    if "[INST]" in s and "<<SYS>>" in s:
        return "llama2"
    if "[INST]" in s:
        return "mistral"
    if "<|end|>" in s and "<|assistant|>" in s:
        return "phi3"
    if "<|assistant|>" in s:
        return "zephyr"
    if "end▁of▁sentence" in s:
        return "deepseek"
    return "chatml"


def apply_chat_template(messages: list[dict], *, template: str | None = None,
                        add_generation_prompt: bool = True,
                        bos_token: str = "", eos_token: str = "",
                        tools: list | None = None) -> str:
    """Render a chat into a prompt string.

    ``template``: raw jinja source (GGUF tokenizer.chat_template) or one of
    the FALLBACK_TEMPLATES names; None falls back to chatml."""
    msgs = [dict(m) for m in messages]
    for m in msgs:      # flatten OpenAI content-part lists
        c = m.get("content")
        if isinstance(c, list):
            m["content"] = "".join(p.get("text", "") for p in c
                                   if isinstance(p, dict))
    if template in FALLBACK_TEMPLATES:
        return FALLBACK_TEMPLATES[template](msgs, add_generation_prompt)
    if template and ("{{" in template or "{%" in template):
        try:
            import jinja2
        except ImportError as e:
            raise ImportError(
                "rendering a jinja chat template needs the jinja2 package; "
                "install it, or pass one of the built-in templates "
                f"{sorted(FALLBACK_TEMPLATES)}") from e
        try:
            env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True,
                                     extensions=["jinja2.ext.loopcontrols"])
            env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
            env.globals["raise_exception"] = _raise_exception
            env.globals["strftime_now"] = lambda fmt: ""
            return env.from_string(template).render(
                messages=msgs, add_generation_prompt=add_generation_prompt,
                bos_token=bos_token, eos_token=eos_token, tools=tools)
        except Exception:
            name = detect_template_name(template)
            return FALLBACK_TEMPLATES[name](msgs, add_generation_prompt)
    return _chatml(msgs, add_generation_prompt)


def _raise_exception(msg):
    raise ValueError(msg)


# --------------------------------------------------------------------------
# reasoning + tool-call output parsing

THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def split_reasoning(text: str) -> tuple[str, str]:
    """Split <think>...</think> reasoning from content (deepseek-r1 / qwen3
    reasoning_content extraction in the server's chat parsers)."""
    thoughts = THINK_RE.findall(text)
    content = THINK_RE.sub("", text)
    # an unterminated leading <think> means everything so far is reasoning
    if "<think>" in content:
        head, _, tail = content.partition("<think>")
        thoughts.append(tail)
        content = head
    return "\n".join(t.strip() for t in thoughts), content.strip()


@dataclass
class ToolCall:
    name: str
    arguments: str          # JSON string, OpenAI wire format
    id: str = field(default_factory=lambda: "call_" + uuid.uuid4().hex[:12])

    def to_openai(self):
        return {"id": self.id, "type": "function",
                "function": {"name": self.name, "arguments": self.arguments}}


HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
FUNC_TAG_RE = re.compile(r"<function=([\w.\-]+)>\s*(\{.*?\})\s*</function>", re.DOTALL)
MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.DOTALL)


def _mk(obj) -> ToolCall | None:
    if not isinstance(obj, dict):
        return None
    name = obj.get("name") or obj.get("function", {}).get("name")
    if not name:
        return None
    args = obj.get("arguments", obj.get("parameters",
                   obj.get("function", {}).get("arguments", {})))
    if not isinstance(args, str):
        args = json.dumps(args)
    return ToolCall(name=name, arguments=args)


def parse_tool_calls(text: str) -> tuple[str, list[ToolCall]]:
    """Extract tool calls from model output; returns (remaining_content,
    calls). Recognizes Hermes/Qwen, functionary tags, Mistral [TOOL_CALLS],
    and bare-JSON llama3.1 style."""
    calls: list[ToolCall] = []

    def sub_hermes(m):
        try:
            tc = _mk(json.loads(m.group(1)))
            if tc:
                calls.append(tc)
                return ""
        except json.JSONDecodeError:
            pass
        return m.group(0)

    text = HERMES_RE.sub(sub_hermes, text)

    def sub_func(m):
        try:
            args = json.loads(m.group(2))
            calls.append(ToolCall(name=m.group(1), arguments=json.dumps(args)))
            return ""
        except json.JSONDecodeError:
            return m.group(0)

    text = FUNC_TAG_RE.sub(sub_func, text)

    m = MISTRAL_RE.search(text)
    if m:
        try:
            arr = json.loads(m.group(1))
            got = [_mk(o) for o in arr]
            if all(got):
                calls.extend(got)
                text = text[:m.start()] + text[m.end():]
        except json.JSONDecodeError:
            pass

    # llama-3.1 bare JSON: entire content is {"name": ..., "parameters": ...}
    if not calls:
        stripped = text.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            try:
                obj = json.loads(stripped)
                if isinstance(obj, dict) and "name" in obj and (
                        "parameters" in obj or "arguments" in obj):
                    tc = _mk(obj)
                    if tc:
                        calls.append(tc)
                        text = ""
            except json.JSONDecodeError:
                pass
    return text.strip(), calls
