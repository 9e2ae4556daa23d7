"""The port's multimodal encoders (models/clip.py) and media decoders
(runtime/media.py) against the JAX package on the CPU.

Encoders: the JAX tree fetched to numpy (models/convert.clip_from_numpy /
audio_from_numpy) and the port's own load of the same tiny mmproj GGUF,
each through the port's forward, held to the JAX forward within 1e-4 of
the largest |output| (float32 on both sides; the products and the
attention sum in other orders; observed below 3e-6). Image preprocessing:
the port's bicubic resize against JAX's PIL path, within 1/255 a channel
(observed: equal). The PNG decoder against PIL, exactly."""
import io
import sys
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from fixtures import make_tiny_audio_mmproj_gguf, make_tiny_mmproj_gguf
from ik_llama_cpp_tpu.models import clip as JC
from ik_llama_cpp_tpu_torch.models import clip as TC
from ik_llama_cpp_tpu_torch.models.convert import audio_from_numpy, clip_from_numpy
from ik_llama_cpp_tpu_torch.runtime import media
from test_torch_archs import rewrite

TOL = 1e-4
Image = pytest.importorskip("PIL.Image")


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * np.abs(a).max(), np.abs(a - b).max()


def _img(h=40, w=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


VISION = {  # rewrite options over the llava fixture
    "mlp": {},
    "input_projection": {"rename": {"mm.0.": "mm.input_projection."}, "drop": ("mm.2.",)},
    "model_fc": {"rename": {"mm.0.": "mm.model.fc."}, "drop": ("mm.2.",)},
    "gelu_no_post_ln": {"drop": ("v.post_ln",), "extra_kv": {"clip.use_gelu": True}},
    "no_class_token": {"drop": ("v.class_embd",)},
}


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("clip")


@pytest.mark.parametrize("case", list(VISION))
def test_clip_forward_matches_jax(tiny_dir, case):
    src = make_tiny_mmproj_gguf(tiny_dir / "mm.gguf", seed=4)
    path = rewrite(src, tiny_dir / f"mm_{case}.gguf", **VISION[case]) if VISION[case] else src
    je, te = JC.ClipEncoder(path), TC.ClipEncoder(path, "cpu")
    assert asdict(te.cfg) == asdict(je.cfg)
    img = _img(seed=1)
    want = je.encode(img)
    # the port's load of the file, and the JAX tree carried across
    _close(want, te.encode(img).numpy())
    px = torch.from_numpy(JC.preprocess_image(img, je.cfg))
    tree = clip_from_numpy(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    _close(want, TC.clip_forward(tree, te.cfg, px).numpy())
    n_rows = te.n_patch_tokens
    assert want.shape == (n_rows, 64)


@pytest.mark.parametrize("projector,stack,seconds", [
    ("qwen2a", 0, 1.0), ("ultravox", 4, 1.0), ("voxtral", 4, 1.0), ("ultravox", 3, 0.7),
    ("voxtral", 3, 31.0)])
def test_whisper_forward_matches_jax(tiny_dir, projector, stack, seconds):
    """Each projector, frame stacking with and without its zero padding,
    and more than one 3,000-frame chunk (31 s)."""
    path = make_tiny_audio_mmproj_gguf(tiny_dir / f"a_{projector}_{stack}.gguf",
                                       projector=projector, stack_factor=stack or 4, seed=5)
    je, te = JC.AudioEncoder(path), TC.AudioEncoder(path, "cpu")
    assert asdict(te.cfg) == asdict(je.cfg)
    t = np.arange(int(16000 * seconds), dtype=np.float32) / 16000
    s = (0.4 * np.sin(2 * np.pi * 330 * t)
         + 0.02 * np.random.default_rng(2).standard_normal(len(t))).astype(np.float32)
    want = je.encode(s)
    _close(want, te.encode(s).numpy())
    from ik_llama_cpp_tpu_torch.runtime.mtmd_audio import preprocess_audio
    mel = torch.from_numpy(preprocess_audio(s)[0])
    tree = audio_from_numpy(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    first = TC.whisper_forward(tree, te.cfg, mel).numpy()
    _close(want[:len(first)], first)


@pytest.mark.parametrize("h,w", [(20, 30), (40, 40), (480, 640), (100, 37), (28, 28)])
def test_preprocess_image_matches_pil(tiny_dir, h, w):
    """Upscale, downscale, a ragged aspect and no resize: JAX's PIL bicubic
    path within 1/255 a channel (before the mean/std normalization)."""
    cfg = JC.ClipEncoder(make_tiny_mmproj_gguf(tiny_dir / "mm.gguf", seed=4)).cfg
    img = _img(h, w, seed=h + w)
    a, b = JC.preprocess_image(img, cfg), TC.preprocess_image(img, cfg)
    std = np.asarray(cfg.image_std, np.float32)[:, None, None]
    assert a.shape == b.shape and np.abs((a - b) * std).max() <= 1 / 255 + 1e-6
    want = np.asarray(Image.fromarray(img).resize((53, 17), Image.BICUBIC))
    assert np.array_equal(TC.resize_bicubic(img, 53, 17), want)


def _png(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (1, 2, 3, 4, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_png_filters_match_pil(filters):
    img = _img(37, 53, seed=7)
    data = media.encode_png(img, filters)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(want, img) and np.array_equal(media.decode_png(data), want)


@pytest.mark.parametrize("mode", ["RGBA", "L", "LA", "P2", "P4", "P16", "P256"])
def test_png_modes_match_pil(mode):
    """Colour types as PIL writes them (its own filter choice per row):
    alpha dropped, gray repeated, palettes of 1, 2, 4 and 8 bits a pixel
    looked up."""
    im = Image.fromarray(_img(31, 45, seed=9))
    if mode.startswith("P"):
        n = int(mode[1:])
        data = _png(im.quantize(n)) if n == 256 else b""
        if not data:
            buf = io.BytesIO()
            im.quantize(n).save(buf, "PNG", bits=max(1, int(np.log2(n))))
            data = buf.getvalue()
    else:
        data = _png(im.convert(mode))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(media.decode_png(data), want)
    assert np.array_equal(media.decode_image(data), want)


def test_decode_image_without_pil(monkeypatch):
    """Where PIL does not import, a PNG still decodes and another format is
    refused by name."""
    img = _img(12, 10)
    jpeg = io.BytesIO()
    Image.fromarray(img).save(jpeg, "JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(media.decode_image(media.encode_png(img)), img)
    with pytest.raises(ValueError, match="JPEG"):
        media.decode_image(jpeg.getvalue())
    with pytest.raises(ValueError, match="interlaced|not a PNG|PNG"):
        media.decode_png(b"\x89PNG\r\n\x1a\n")


def test_decode_wav_matches_jax():
    """The port's copy of the JAX server's decode_wav: PCM16 mono and
    stereo at 16 and 8 kHz, and raw float32 passed through."""
    import wave
    from ik_llama_cpp_tpu.server.app import decode_wav as j_decode
    rng = np.random.default_rng(3)
    for ch, rate in ((1, 16000), (2, 16000), (1, 8000)):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(ch)
            f.setsampwidth(2)
            f.setframerate(rate)
            f.writeframes(rng.integers(-30000, 30000, 4000 * ch, dtype=np.int16).tobytes())
        data = buf.getvalue()
        assert np.array_equal(media.decode_wav(data), j_decode(data))
    raw = rng.standard_normal(100).astype(np.float32).tobytes()
    assert np.array_equal(media.decode_wav(raw), j_decode(raw))
