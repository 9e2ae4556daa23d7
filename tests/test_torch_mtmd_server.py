"""The port's server on the multimodal path, in process on the CPU (the
tiny llama with the tiny CLIP and whisper mmprojs, loaded by
``load_mmproj`` as ``--mmproj`` loads them): an image chat (a PNG data URL)
and an audio chat (a base64 WAV) answer the JAX runtime's generate_mm
greedy text on the same prompt and media; the media run on the engine's
loop thread; /props and /v1/props report the modalities; a PNG needs no
PIL, another format without PIL is a 400 that names it; /v1/responses
with an input_image stays a 400, as in the JAX server; Anthropic image
blocks, which the JAX server drops without a word, are a 400."""
import base64
import io
import sys
import threading
import wave

import numpy as np
import pytest

from fixtures import make_tiny_audio_mmproj_gguf, make_tiny_llama_gguf, make_tiny_mmproj_gguf
from ik_llama_cpp_tpu.models import clip as JC
from ik_llama_cpp_tpu.runtime import mtmd as JM
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.runtime import mtmd as TM
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.media import encode_png
from ik_llama_cpp_tpu_torch.server.app import DONE, RequestError, Server, load_mmproj
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmsrv")
    return dict(model=make_tiny_llama_gguf(d / "text.gguf", seed=3),
                vision=make_tiny_mmproj_gguf(d / "mmproj.gguf", seed=4),
                audio=make_tiny_audio_mmproj_gguf(d / "audio.gguf", seed=5))


@pytest.fixture(scope="module")
def srv(files):
    eng = BatchEngine(Runtime.from_gguf(files["model"], device="cpu"), n_slots=2, capacity=1024)
    s = Server(eng, model_name="tiny")
    load_mmproj(s, str(files["vision"]))
    load_mmproj(s, str(files["audio"]))
    eng.start()
    yield s
    eng.stop()


IMG = np.random.default_rng(0).integers(0, 255, (40, 50, 3), dtype=np.uint8)


def _wav_bytes(seconds=1.0) -> tuple[bytes, np.ndarray]:
    t = np.arange(int(16000 * seconds)) / 16000.0
    pcm = (0.4 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return buf.getvalue(), pcm.astype(np.float32) / 32768.0


def _image_part(data: bytes, kind: str = "png") -> dict:
    return {"type": "image_url",
            "image_url": {"url": f"data:image/{kind};base64," + base64.b64encode(data).decode()}}


def _chat(part, n=6):
    return {"messages": [{"role": "user", "content": [{"type": "text", "text": "what is it?"},
                                                     part]}],
            "max_tokens": n, "temperature": 0}


def _jax_reply(files, srv, marker, media):
    """The JAX runtime's generate_mm greedy text for the prompt the port's
    chat template makes of the chat."""
    prompt = srv._chat_prompt([{"role": "user", "content": "what is it?" + marker}])
    jr = JRuntime.from_gguf(files["model"])
    n, out = JM.generate_mm(jr, prompt, [media], JC.ClipEncoder(files["vision"]),
                            audio_encoder=JC.AudioEncoder(files["audio"]), max_new_tokens=6,
                            capacity=1024)
    eos = jr.tokenizer.eos_id
    return n, out, srv._mm_message(jr.tokenizer.decode([t for t in out if t != eos]))["content"]


def test_image_chat_matches_jax(files, srv, monkeypatch):
    seen = []
    real = TM.generate_mm
    monkeypatch.setattr(TM, "generate_mm", lambda *a, **k: seen.append(
        threading.current_thread()) or real(*a, **k))
    r = srv.oai_chat(_chat(_image_part(encode_png(IMG))))
    n, out, text = _jax_reply(files, srv, "<__image__>", IMG)
    assert r["object"] == "chat.completion" and r["choices"][0]["message"]["content"] == text
    assert r["usage"] == {"prompt_tokens": n, "completion_tokens": len(out),
                          "total_tokens": n + len(out)}
    assert seen == [srv.engine._thread]          # on the engine's loop thread


def test_audio_chat_matches_jax(files, srv):
    data, samples = _wav_bytes()
    part = {"type": "input_audio",
            "input_audio": {"data": base64.b64encode(data).decode(), "format": "wav"}}
    r = srv.oai_chat(_chat(part))
    n, out, text = _jax_reply(files, srv, "<__audio__>", samples)
    assert r["choices"][0]["message"]["content"] == text and r["usage"]["prompt_tokens"] == n
    events = list(srv.oai_chat_stream(_chat(part)))
    assert events[-1] == DONE and events[0]["data"]["choices"][0]["delta"]["content"] == text


def test_modalities(srv, files):
    assert srv.props()["modalities"] == {"vision": True, "audio": True}
    assert srv.props_simple()["modalities"] == {"vision": True, "audio": True}
    bare = Server(srv.engine)
    assert bare.props()["modalities"] == {"vision": False, "audio": False}


def test_png_without_pil(srv, monkeypatch):
    """Where PIL does not import, a PNG chat is answered and a JPEG one is
    a 400 that names the format."""
    pil = pytest.importorskip("PIL.Image")
    jpeg = io.BytesIO()
    pil.fromarray(IMG).save(jpeg, "JPEG")
    want = srv.oai_chat(_chat(_image_part(encode_png(IMG))))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = srv.oai_chat(_chat(_image_part(encode_png(IMG))))
    assert got["choices"] == want["choices"]
    with pytest.raises(RequestError) as e:
        srv.oai_chat(_chat(_image_part(jpeg.getvalue(), "jpeg")))
    assert e.value.status == 400 and "JPEG" in e.value.payload["error"]["message"]


def test_responses_and_anthropic_refuse_images(srv):
    n = srv.engine.n_requests
    body = {"input": [{"role": "user", "content": [
        {"type": "input_text", "text": "hi"},
        {"type": "input_image", "image_url": "data:image/png;base64,"
         + base64.b64encode(encode_png(IMG)).decode()}]}]}
    with pytest.raises(RequestError) as e:
        srv.oai_responses(body)
    assert e.value.status == 400 and "/v1/responses" in e.value.payload["error"]["message"]
    with pytest.raises(RequestError) as e:
        srv.anthropic_messages({"messages": [{"role": "user", "content": [
            {"type": "image", "source": {}}, {"type": "text", "text": "hi"}]}]})
    assert e.value.status == 400 and "/v1/messages" in e.value.payload["error"]["message"]
    assert srv.engine.n_requests == n


@pytest.mark.parametrize("data,kind", [(b"\x89PNG\r\n\x1a\n" + b"\x00" * 30, "image_url"),
                                       (b"\x89PNG\r\n\x1a\n\x00\x00\x00\x0dIHDR", "image_url"),
                                       (b"RIFF\x24\x00\x00\x00WAVEfmt ", "input_audio")],
                         ids=["png-no-header", "png-truncated", "wav-truncated"])
def test_malformed_media_is_a_400(srv, data, kind):
    part = (_image_part(data) if kind == "image_url" else
            {"type": "input_audio", "input_audio": {"data": base64.b64encode(data).decode()}})
    n = srv.engine.n_requests
    with pytest.raises(RequestError) as e:
        srv.oai_chat(_chat(part))
    assert e.value.status == 400 and kind in e.value.payload["error"]["message"]
    assert srv.engine.n_requests == n
