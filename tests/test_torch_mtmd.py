"""The port's multimodal runtime (runtime/mtmd.py) against the JAX
package's on the CPU, on the tiny llama text model with the tiny CLIP and
whisper mmprojs: the spliced rows (text rows exactly, media rows within
1e-4 of the largest |row|, the encoders' float32 rule), generate_mm's
greedy tokens equal, every step's logits over the JAX tokens within 2% of
the largest logit (test_torch_archs.py's rule), the marker errors, and
eval_embeds on a ring cache, where the port passes each chunk's live
length (n_valid) and the JAX runtime passes none."""
import numpy as np
import pytest
import torch

from fixtures import (make_tiny_audio_mmproj_gguf, make_tiny_gptoss_gguf, make_tiny_llama_gguf,
                      make_tiny_mmproj_gguf)
from ik_llama_cpp_tpu.models import clip as JC
from ik_llama_cpp_tpu.runtime import mtmd as JM
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.models import clip as TC
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.runtime import mtmd as TM
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from test_torch_archs import TOL

ROW_TOL = 1e-4


@pytest.fixture(scope="module")
def mm(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtmd")
    model = make_tiny_llama_gguf(d / "text.gguf", seed=3)
    vis = make_tiny_mmproj_gguf(d / "mmproj.gguf", seed=4)
    aud = make_tiny_audio_mmproj_gguf(d / "audio.gguf", seed=5)
    return dict(jr=JRuntime.from_gguf(model), tr=TRuntime.from_gguf(model, device="cpu"),
                je=JC.ClipEncoder(vis), te=TC.ClipEncoder(vis, "cpu"),
                ja=JC.AudioEncoder(aud), ta=TC.AudioEncoder(aud, "cpu"))


def _img(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (40, 40, 3), dtype=np.uint8)


def _wav(seconds=1.0, seed=0):
    t = np.arange(int(16000 * seconds), dtype=np.float32) / 16000
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(len(t))).astype(
        np.float32)


CASES = {"image": ("describe <__image__> please", lambda: [_img()]),
         "audio": ("listen: <__audio__>", lambda: [_wav()]),
         "both": ("<__image__> then <__audio__> and <__image__>",
                  lambda: [_img(1), _wav(0.5, 2), _img(2)])}


def _both(mm, fn_j, fn_t, prompt, media):
    return (fn_j(mm["jr"], prompt, media, mm["je"], audio_encoder=mm["ja"]),
            fn_t(mm["tr"], prompt, media, mm["te"], audio_encoder=mm["ta"]))


@pytest.mark.parametrize("case", list(CASES))
def test_splice_matches_jax(mm, case):
    prompt, media = CASES[case]
    a, b = _both(mm, JM.build_mm_embeds, TM.build_mm_embeds, prompt, media())
    b = b.numpy()
    assert a.shape == b.shape and b.dtype == np.float32
    assert np.abs(a - b).max() <= ROW_TOL * np.abs(a).max()


@pytest.mark.parametrize("case", ["image", "audio"])
def test_generate_mm_matches_jax(mm, case):
    """Greedy tokens equal; then both runtimes fed the JAX tokens (the
    splice, then one token a step) give every step's logits within 2% of
    the largest."""
    prompt, media = CASES[case]
    m = media()
    (nj, toks_j), (nt, toks_t) = _both(
        mm, lambda *a, **k: JM.generate_mm(*a, max_new_tokens=8, capacity=128, **k),
        lambda *a, **k: TM.generate_mm(*a, max_new_tokens=8, capacity=128, **k), prompt, m)
    assert nj == nt and toks_t == toks_j and len(toks_t) >= 1
    ej, et = _both(mm, JM.build_mm_embeds, TM.build_mm_embeds, prompt, m)
    jr, tr = mm["jr"], mm["tr"]
    cap = len(ej) + 64
    lj, kvj, npj = JM.eval_embeds(jr, ej, jr.new_cache(1, cap), 0)
    lt, kvt, npt = TM.eval_embeds(tr, et, tr.new_cache(1, cap), 0)
    js, ts = [np.asarray(lj)], [lt.numpy()]
    for tok in toks_j[:-1]:
        a, kvj, npj = jr.eval_tokens([tok], kvj, npj)
        b, kvt, npt = tr.eval_tokens([tok], kvt, npt)
        js.append(np.asarray(a)[-1])
        ts.append(b[-1].numpy())
    js, ts = np.stack(js), np.stack(ts)
    assert np.abs(js - ts).max() <= TOL * np.abs(js).max()


def test_marker_errors(mm):
    tr, te, ta = mm["tr"], mm["te"], mm["ta"]
    for prompt, media in (("no marker here", [_img()]), ("<__image__> <__image__>", [_img()]),
                          ("<__audio__>", [])):
        with pytest.raises(ValueError, match="media markers"):
            TM.build_mm_embeds(tr, prompt, media, te, audio_encoder=ta)
    with pytest.raises(ValueError, match="audio encoder"):
        TM.build_mm_embeds(tr, "<__audio__>", [_wav()], te)
    with pytest.raises(ValueError, match="vision encoder"):
        TM.build_mm_embeds(tr, "<__image__>", [_img()], None, audio_encoder=ta)


def test_eval_embeds_n_valid_on_a_ring(tmp_path, monkeypatch):
    """On ring caches (--swa-compress, gpt-oss: a 32-key window, a ring of
    640 rows) 700 rows go in as chunks of 512 and 188 (padded to 256): the
    port passes each chunk's live length, so the padded rows never land in
    the ring, and the logits equal eval_tokens' over the same ids bit for
    bit, and the full cache's within 1% of the largest (the rule of
    test_torch_swa_compress.py)."""
    tr = TRuntime.from_gguf(make_tiny_gptoss_gguf(tmp_path / "oss.gguf"), device="cpu",
                            swa_compress=True)
    ids = [int(x) for x in np.random.default_rng(4).integers(3, 250, 700)]
    rows = tr.params["tok_embd"][torch.tensor(ids)].float()
    seen = []
    fwd = TM.FORWARDS[tr.cfg.arch]
    monkeypatch.setitem(TM.FORWARDS, tr.cfg.arch,
                        lambda *a, **k: seen.append(k.get("n_valid")) or fwd(*a, **k))
    kv = tr.new_cache(1, 900)
    assert isinstance(kv, TLM.SwaKVCache) and tr.needs_n_valid
    last, kv, n = TM.eval_embeds(tr, rows, kv, 0)
    assert seen == [512, 188] and n == 700
    want = tr.eval_tokens(ids, tr.new_cache(1, 900), 0)[0][-1]
    assert torch.equal(last, want)
    full = TRuntime(cfg=tr.cfg, params=tr.params, device=tr.device)
    ref = TM.eval_embeds(full, rows, full.new_cache(1, 900), 0)[0]
    assert (last - ref).abs().max() <= 1e-2 * ref.abs().max()
