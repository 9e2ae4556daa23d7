"""Multimodal runtime — examples/mtmd analogue: splice vision/audio-encoder
outputs into the text stream as embedding rows.

The torch counterpart of the JAX package's ``runtime/mtmd.py``. Prompts use
the ``<__image__>`` / ``<__audio__>`` markers (mtmd_default_marker): text
segments are tokenized and embedded normally; each marker is replaced by
the encoder projector's output rows (CLIP patch rows for images,
whisper-encoder frames for audio); the combined (T, E) sequence is
prefilled through the model's ``inputs_embeds`` (llama_batch.embd) in
bucket-padded chunks, then generation continues token by token through
``Runtime.eval_tokens``.

Where the runtime needs each chunk's live length (``Runtime.needs_n_valid``:
ring caches, recurrent models), ``eval_embeds`` passes it, so a padded row
never lands in a ring or a state; the JAX ``eval_embeds`` passes none.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .generate import FORWARDS, PREFILL_BUCKETS, Runtime, _bucket, _chunk_limit
from .sampling import SamplerParams, SamplerState, sample as sample_token

DEFAULT_MARKER = "<__image__>"
AUDIO_MARKER = "<__audio__>"


def build_mm_embeds(rt: Runtime, prompt: str, images: list, encoder,
                    marker: str = DEFAULT_MARKER, audio_encoder=None) -> torch.Tensor:
    """Tokenize text segments + encode media -> (T, E) float32 rows on the
    runtime's device.

    ``images`` holds the media items in marker order: (H, W, 3) uint8
    arrays (or PIL images) for ``<__image__>`` markers, 1-D float32 16 kHz
    sample arrays for ``<__audio__>`` markers. ``encoder`` serves image
    markers, ``audio_encoder`` audio markers (either may be None when that
    marker kind is absent)."""
    pieces = re.split(f"({re.escape(marker)}|{re.escape(AUDIO_MARKER)})", prompt)
    segments = pieces[0::2]
    markers = pieces[1::2]
    if len(markers) != len(images):
        raise ValueError(f"prompt has {len(markers)} media markers but "
                         f"{len(images)} media items were supplied")
    tok_embd = rt.params["tok_embd"]
    tok = rt.tokenizer
    parts = []

    def embed(ids: list[int]) -> torch.Tensor:
        return tok_embd[torch.as_tensor(ids, device=tok_embd.device)].float()

    for i, seg in enumerate(segments):
        if seg:
            parts.append(embed(tok.encode(seg, add_bos=(i == 0))))
        elif i == 0 and tok.add_bos and tok.bos_id >= 0:
            parts.append(embed([tok.bos_id]))
        if i < len(markers):
            if markers[i] == AUDIO_MARKER:
                if audio_encoder is None:
                    raise ValueError("audio marker but no audio encoder "
                                     "(mmproj without an audio tower?)")
                mm = audio_encoder.encode(np.asarray(images[i], np.float32))
            else:
                if encoder is None:
                    raise ValueError("image marker but no vision encoder")
                mm = encoder.encode(images[i])                   # (P, E_text)
            if mm.shape[1] != tok_embd.shape[1]:
                raise ValueError(
                    f"projector dim {mm.shape[1]} != model n_embd "
                    f"{tok_embd.shape[1]} — wrong mmproj for this model?")
            parts.append(mm.to(device=rt.device, dtype=torch.float32))
    return torch.cat(parts, dim=0)


def eval_embeds(rt: Runtime, embds: torch.Tensor, kv, n_past: int = 0):
    """Prefill a (T, E) row sequence in chunks of at most the largest
    prefill bucket, each zero-padded to its bucket; returns (the last row's
    logits (V,) float32 on the device, kv, n_past)."""
    fwd = FORWARDS[rt.cfg.arch]
    embds = embds.to(device=rt.device, dtype=torch.float32)
    t, e = embds.shape
    i, last = 0, None
    while i < t:
        chunk = embds[i:i + min(PREFILL_BUCKETS[-1], _chunk_limit(kv, n_past))]
        n = chunk.shape[0]
        b = _bucket(n)
        padded = torch.zeros((1, b, e), dtype=torch.float32, device=rt.device)
        padded[0, :n] = chunk
        tokens = torch.zeros((1, b), dtype=torch.int64, device=rt.device)
        kw = {"n_valid": n} if rt.needs_n_valid else {}
        logits = fwd(rt.params, rt.cfg, tokens, kv, n_past, inputs_embeds=padded, **kw)
        last = logits[0, n - 1]
        n_past += n
        i += n
    return last, kv, n_past


def generate_mm(rt: Runtime, prompt: str, images: list, encoder, *,
                max_new_tokens: int = 64, sampler: SamplerParams | None = None,
                seed: int = 0, capacity: int = 2048, marker: str = DEFAULT_MARKER,
                audio_encoder=None) -> tuple[int, list[int]]:
    """Multimodal generation on a fresh one-row cache; returns
    (n_prompt_positions, generated ids)."""
    sampler = sampler or SamplerParams(temp=0.0)
    embds = build_mm_embeds(rt, prompt, images, encoder, marker,
                            audio_encoder=audio_encoder)
    capacity = max(capacity, embds.shape[0] + max_new_tokens + 8)
    kv = rt.new_cache(1, capacity)
    logits, kv, n_past = eval_embeds(rt, embds, kv, 0)
    rng = np.random.default_rng(seed)
    state = SamplerState()
    out: list[int] = []
    for _ in range(max_new_tokens):
        tok = sample_token(logits.cpu().numpy(), sampler, rng, history=out, state=state)
        out.append(int(tok))
        if tok == rt.eos_id:
            break
        lg, kv, n_past = rt.eval_tokens([int(tok)], kv, n_past)
        logits = lg[-1]
    return embds.shape[0], out
