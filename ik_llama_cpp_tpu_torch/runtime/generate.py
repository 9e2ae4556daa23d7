"""Model runtime: load a GGUF, prefill in bucketed chunks, greedy decode.

The torch counterpart of the JAX package's ``runtime/generate.py:Runtime``
for the llama, qwen3moe and qwen2moe paths (MoE experts in any of their
loaded forms: int8 per supergroup, planar, mixed or bf16; shared experts),
with a bf16 or quantized KV cache.
PyTorch runs eagerly, so there are no compiled step functions; the prefill
buckets and the chunk limit are kept so that cache rows and chunking match
the JAX runtime exactly.

The runtime runs on ``cuda`` unless the caller passes ``device="cpu"``; it
never falls back to the CPU on its own.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..gguf.reader import load_gguf
from ..models import llama as llama_mod
from ..models.config import ModelConfig, config_from_gguf
from ..models.llama import KVCache, MixedKVCache

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


def _chunk_limit(kv, n_past: int) -> int:
    """Largest token chunk whose bucket-padded cache write still fits:
    a write at n_past touches rows [n_past, n_past + bucket)."""
    room = kv.capacity - n_past
    fit = 0
    for b in PREFILL_BUCKETS:
        if b <= room:
            fit = b
    if fit == 0:
        raise ValueError(
            f"KV cache full: capacity {kv.capacity}, n_past {n_past}; "
            f"writes are padded to >={PREFILL_BUCKETS[0]}-token buckets — "
            "allocate headroom (Runtime.new_cache rounds this up for you)")
    return fit


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


@dataclass
class Runtime:
    cfg: ModelConfig
    params: dict
    device: torch.device
    eos_id: int = -1
    # KV cache type: False (bf16) | True / 'q8' | 'q4' | 'q6' | 'nl4' /
    # 'iq4_nl' | a per-layer dict {"type", "first", "n_first", "last", "n_last"}
    kv_quant: "bool | str | dict" = False

    @classmethod
    def from_gguf(cls, path, device=None, *, use_quant: bool = True,
                  fuse: bool = True, kv_quant=False, swa_compress: bool = False,
                  tensor_parallel: int = 0, layer_split: int = 0,
                  k_hadamard: bool = False, v_hadamard: bool = False):
        """``kv_quant`` picks the cache type of ``new_cache``; ``k_hadamard``
        / ``v_hadamard`` (-khad / -vhad) rotate K (with q) and V by a
        head-dim Hadamard before the cache write."""
        dev = resolve_device(device)
        if swa_compress:
            llama_mod._later("SWA ring caches (--swa-compress)", "other-architectures")
        if tensor_parallel > 1 or layer_split > 1:
            llama_mod._later("tensor / pipeline parallel serving", "multi-GPU")
        gg = load_gguf(path)
        cfg = config_from_gguf(gg.metadata)
        if k_hadamard or v_hadamard:
            cfg = replace(cfg, k_hadamard=k_hadamard, v_hadamard=v_hadamard)
        params = llama_mod.load_llama_params(gg, cfg, dev, use_quant=use_quant,
                                             fuse=fuse)
        eos = int(gg.metadata.get("tokenizer.ggml.eos_token_id", -1))
        return cls(cfg=cfg, params=params, device=dev, eos_id=eos,
                   kv_quant=kv_quant)

    def new_cache(self, batch: int = 1, capacity: int = 512):
        # room for a bucket-padded write at the last row, rounded to 256
        # rows as the JAX runtime does (its decode kernel's tile rule), so
        # both runtimes hold the same cache rows
        b0 = max(PREFILL_BUCKETS[0], 256)
        capacity = -(-(capacity + PREFILL_BUCKETS[0] - 1) // b0) * b0
        quant = self.kv_quant
        if isinstance(quant, dict):
            # per-layer first/last codec overrides, e.g. {"type": "q4",
            # "first": "q8", "n_first": 1, "last": "q8", "n_last": 1}
            ovr = quant.get("first", quant.get("last", "q8"))
            n_first = int(quant.get("n_first", 1 if "first" in quant else 0))
            n_last = int(quant.get("n_last", 1 if "last" in quant else 0))
            if n_first + n_last < self.cfg.n_layer:
                return MixedKVCache.create(
                    self.cfg, batch, capacity, self.device,
                    mid=quant.get("type", "q4"), override=ovr,
                    n_first=n_first, n_last=n_last)
            quant = ovr      # every layer overridden: a plain cache of that codec
        return KVCache.create(self.cfg, batch, capacity, self.device, quant=quant)

    def eval_tokens(self, ids: list[int], kv, n_past: int = 0, *,
                    all_logits: bool = False):
        """Evaluate ids in bucket-padded chunks; returns (logits, kv, n_past)
        with the logits of every position (all_logits) or of the last one,
        as a float32 (n, V) tensor on the runtime's device."""
        out_chunks = []
        logits = None
        last_len = 0
        i = 0
        while i < len(ids):
            chunk = ids[i:i + _chunk_limit(kv, n_past)]
            padded = torch.zeros((1, _bucket(len(chunk))), dtype=torch.int64)
            padded[0, :len(chunk)] = torch.as_tensor(chunk, dtype=torch.int64)
            logits = llama_mod.forward(self.params, self.cfg,
                                       padded.to(self.device), kv, n_past)
            if all_logits:
                out_chunks.append(logits[0, :len(chunk)])
            last_len = len(chunk)
            n_past += len(chunk)
            i += len(chunk)
        if all_logits:
            return torch.cat(out_chunks, dim=0), kv, n_past
        return logits[0, last_len - 1:last_len], kv, n_past

    def generate(self, prompt, max_new_tokens: int = 32, sampler=None,
                 capacity: int = 512, stop_at_eos: bool = True):
        """Greedy generation, one eval_tokens call per token. Returns
        (prompt_ids, generated_ids)."""
        if sampler is not None and getattr(sampler, "temp", 0.0) > 0.0:
            llama_mod._later("sampled generation", "sampling")
        ids = self._ids(prompt)
        kv = self.new_cache(1, capacity)
        logits, kv, n_past = self.eval_tokens(ids, kv, 0)
        out = []
        for _ in range(max_new_tokens):
            tok = int(torch.argmax(logits[-1]))
            out.append(tok)
            if stop_at_eos and tok == self.eos_id:
                break
            logits, kv, n_past = self.eval_tokens([tok], kv, n_past)
        return ids, out

    def _decode_loop(self, tok0: torch.Tensor, kv, n_past: int,
                     n_steps: int) -> torch.Tensor:
        """Greedy decode of n_steps tokens after tok0 (B, 1): a Python loop
        over device steps. The argmax stays on the device and nothing is
        read back per token; positions come from one device arange made up
        front. Returns the (B, n_steps) tokens on the device."""
        b = tok0.shape[0]
        pos = (n_past + torch.arange(n_steps, dtype=torch.int32,
                                     device=self.device))
        toks = torch.empty((b, n_steps), dtype=torch.int64, device=self.device)
        tok = tok0
        for s in range(n_steps):
            logits = llama_mod.forward(self.params, self.cfg, tok, kv,
                                       n_past + s,
                                       npv=pos[s:s + 1].expand(b),
                                       logits_last_only=True)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            toks[:, s] = nxt
            tok = nxt[:, None]
        return toks

    def generate_greedy_on_device(self, prompt, max_new_tokens: int = 32,
                                  capacity: int = 512,
                                  stop_at_eos: bool = True):
        """Greedy generation with the decode loop on the device. Returns
        (prompt_ids, generated_ids) like generate()."""
        ids = self._ids(prompt)
        capacity = max(capacity, len(ids) + max_new_tokens + 8)
        kv = self.new_cache(1, capacity)
        logits, kv, n_past = self.eval_tokens(ids, kv, 0)
        first = torch.argmax(logits[-1]).reshape(1, 1)
        if max_new_tokens <= 1:
            return ids, [int(first)]
        toks = self._decode_loop(first, kv, n_past, max_new_tokens - 1)
        out = [int(first)] + toks[0].tolist()
        if stop_at_eos and self.eos_id in out:
            out = out[: out.index(self.eos_id) + 1]
        return ids, out

    @staticmethod
    def _ids(prompt) -> list[int]:
        if isinstance(prompt, str):
            raise NotImplementedError(
                "string prompts need the tokenizer, which is a later slice of "
                "the PyTorch port: pass token ids")
        return [int(t) for t in prompt]
