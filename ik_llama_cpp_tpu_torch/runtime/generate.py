"""Model runtime: load a GGUF, prefill in bucketed chunks, greedy or sampled
decode, text in and out through the GGUF's tokenizer.

The torch counterpart of the JAX package's ``runtime/generate.py:Runtime``
for every architecture of its dense family (``models/llama.py:ARCHS``; MoE
experts in any of their loaded forms: int8 per supergroup, planar, mixed or
bf16; shared experts), with a bf16 or quantized KV cache, or ring caches on
the sliding-window layers (``swa_compress``), and for the DeepSeek-2 family
(``models/deepseek2.py:ARCHS``), loaded with the MLA latent cache, and for
the hybrid delta-net family (``models/qwen3next.py:ARCHS``) and the mamba
family (``models/mamba.py``) on their recurrent caches: a recurrent model's
padded chunk commits only its live tokens to the state (``n_valid``).
PyTorch runs eagerly, so there are no compiled step functions; the prefill
buckets and the chunk limit are kept so that cache rows and chunking match
the JAX runtime exactly.

The BERT family (``models/bert.py``) is an encoder on a ``NoCache``: it
has no LM head, so it serves ``embed`` and ``layer_hiddens`` and refuses
``eval_tokens``.

The speculative verify steps (``_spec_verify``, ``_spec_loop``) and the
MTP layer's runtime (``eval_tokens_hidden``, ``mtp_eval``) serve
``runtime/speculative.py``; the hidden-state paths ``embed`` (pooled
embeddings), ``layer_hiddens`` (the control-vector generator's input) and
``eval_probe`` (lookahead's probe block) serve ``runtime/cvector.py``,
``runtime/lookahead.py``, the server's embeddings routes and the tools.

The runtime runs on ``cuda`` unless the caller passes ``device="cpu"``; it
never falls back to the CPU on its own.
"""
from __future__ import annotations

import collections
import logging
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..gguf.reader import GGUFModel, load_gguf
from ..models import bert as bert_mod
from ..models import deepseek2 as ds2_mod
from ..models import llama as llama_mod
from ..models import mamba as mamba_mod
from ..models import qwen3next as q3n_mod
from ..models.config import ModelConfig, config_from_gguf
from ..models.llama import KVCache, MixedKVCache, SwaKVCache
from .sampling import SamplerParams, SamplerState, sample as sample_token
from .tokenizer import Tokenizer, tokenizer_from_gguf

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _log_model_load(gg: GGUFModel, cfg: ModelConfig) -> None:
    """Reference-style load log: tensor counts and sizes by type, and the
    model's shape."""
    log = logging.getLogger("ik_llama_cpp_tpu_torch")
    counts: dict = collections.Counter()
    nbytes: dict = collections.Counter()
    for info in gg.tensors.values():
        counts[info.ggml_type.name] += 1
        nbytes[info.ggml_type.name] += len(info.data)
    for tname in sorted(counts):
        log.info("model tensors: %-8s %4d tensors  %8.2f MiB",
                 tname, counts[tname], nbytes[tname] / (1 << 20))
    log.info("model: arch=%s layers=%d embd=%d heads=%d/%d ff=%d vocab=%d "
             "ctx_train=%d  file=%.2f MiB", cfg.arch, cfg.n_layer, cfg.n_embd,
             cfg.n_head, cfg.n_head_kv, cfg.n_ff, cfg.n_vocab, cfg.n_ctx_train,
             sum(nbytes.values()) / (1 << 20))


def _gptj_unsupported(*args, **kwargs):
    raise NotImplementedError(
        "gptj is vestigial in the reference too: its tensor map holds only "
        "token_embd and there is no graph builder (llama-model.cpp:171, no "
        "build_gptj in src/graphs/) — every attempt to load a GPT-J GGUF "
        "fails there as well, as it does in the JAX package.")


# every architecture of the dense family runs the one llama graph
FORWARDS = {a: llama_mod.forward for a in llama_mod.ARCHS}
LOADERS = {a: llama_mod.load_llama_params for a in llama_mod.ARCHS}
CACHES = {a: KVCache.create for a in llama_mod.ARCHS}
FORWARDS["gptj"] = LOADERS["gptj"] = CACHES["gptj"] = _gptj_unsupported
# the DeepSeek-2 family: MLA attention, the latent cache by default
for _a in ds2_mod.ARCHS:
    FORWARDS[_a] = ds2_mod.forward
    LOADERS[_a] = ds2_mod.load_deepseek2_params
    CACHES[_a] = ds2_mod.make_cache
# the hybrid delta-net family: attention rows beside a recurrent state
for _a in q3n_mod.ARCHS:
    FORWARDS[_a] = q3n_mod.forward
    LOADERS[_a] = q3n_mod.load_qwen3next_params
    CACHES[_a] = q3n_mod.HybridCache.create
# the mamba family: a selective-scan state and no KV cache
for _a in mamba_mod.ARCHS:
    FORWARDS[_a] = mamba_mod.forward
    LOADERS[_a] = mamba_mod.load_mamba_params
    CACHES[_a] = mamba_mod.MambaCache.create
# the BERT family: an encoder with no cache and no LM head
for _a in bert_mod.ARCHS:
    FORWARDS[_a] = bert_mod.forward
    LOADERS[_a] = bert_mod.load_bert_params
    CACHES[_a] = bert_mod.NoCache.create
RECURRENT_ARCHS = q3n_mod.ARCHS + mamba_mod.ARCHS
# architectures with a forward of their own in the JAX package, not ported yet
OWN_FORWARD = ("deepseek4", "gemma4", "gemma4_mtp", "gemma4-assistant",
               "openpangu", "t5", "dflash")


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


def _chunks(ids: list[int], kv, n_past: int, device):
    """The bucket-padded chunks in which ``ids`` are evaluated from n_past:
    (offset in ids, live length, (1, bucket) int64 tokens on ``device``)
    each, every chunk's padded write inside the cache (_chunk_limit)."""
    i = 0
    while i < len(ids):
        chunk = ids[i:i + _chunk_limit(kv, n_past + i)]
        padded = torch.zeros((1, _bucket(len(chunk))), dtype=torch.int64)
        padded[0, :len(chunk)] = torch.as_tensor(chunk, dtype=torch.int64)
        yield i, len(chunk), padded.to(device)
        i += len(chunk)


FNV_OFFSET, FNV_PRIME = 2166136261, 16777619


def ngram_hash(window, table_bits: int):
    """The slot of an n-gram in the device ngram drafter's table: FNV-1a
    over its tokens with uint32 wraparound, masked to 2**table_bits. The
    tokens are ints (on the host) or 0-d int64 tensors (on the device)."""
    h = FNV_OFFSET
    for t in window:
        h = ((h ^ t) * FNV_PRIME) & 0xFFFFFFFF
    return h & ((1 << table_bits) - 1)


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
    tokenizer: Tokenizer | None = None
    # KV cache type: False (bf16) | True / 'q8' | 'q4' | 'q6' | 'nl4' /
    # 'iq4_nl' | a per-layer dict {"type", "first", "n_first", "last", "n_last"}
    kv_quant: "bool | str | dict" = False
    # ring caches on the sliding-window layers (--swa-compress)
    swa_compress: bool = False

    @classmethod
    def from_gguf(cls, path, device=None, *, use_quant: bool = True,
                  fuse: bool = True, kv_quant=False, swa_compress: bool = False,
                  track_reload: bool = False, tensor_parallel: int = 0, layer_split: int = 0,
                  k_hadamard: bool = False, v_hadamard: bool = False):
        """``kv_quant`` picks the cache type of ``new_cache``; ``k_hadamard``
        / ``v_hadamard`` (-khad / -vhad) rotate K (with q) and V by a
        head-dim Hadamard before the cache write; ``swa_compress`` gives
        ``new_cache`` ring caches on the sliding-window layers where they
        take effect (a bf16 cache longer than window + margin + 128);
        ``track_reload`` records per-tensor CRCs of the file, so that
        ``reload_changed_tensors`` can patch the live weights when it
        changes on disk."""
        dev = resolve_device(device)
        if tensor_parallel > 1 or layer_split > 1:
            llama_mod._later("tensor / pipeline parallel serving", "multi-GPU (item 11)")
        gg = load_gguf(path)
        cfg = config_from_gguf(gg.metadata)
        if k_hadamard or v_hadamard:
            cfg = replace(cfg, k_hadamard=k_hadamard, v_hadamard=v_hadamard)
        loader = LOADERS.get(cfg.arch)
        if loader is None:
            if cfg.arch in OWN_FORWARD:
                llama_mod._later(f"architecture {cfg.arch!r}, which has a forward of "
                                 "its own", "other architectures (item 8)")
            raise NotImplementedError(f"arch {cfg.arch!r} not supported yet")
        # the DeepSeek-2 family loads the latent cache's absorb projections;
        # neither it nor a recurrent family has a q/k/v or gate/up pair to fuse
        kw = ({"mla": True} if cfg.arch in ds2_mod.ARCHS else
              {} if cfg.arch in RECURRENT_ARCHS + bert_mod.ARCHS else {"fuse": fuse})
        params = loader(gg, cfg, dev, use_quant=use_quant, **kw)
        _log_model_load(gg, cfg)
        rt = cls(cfg=cfg, params=params, device=dev,
                 tokenizer=tokenizer_from_gguf(gg.metadata), kv_quant=kv_quant,
                 swa_compress=swa_compress)
        if track_reload:
            from .reload import ReloadInfo
            rt._reload_info = ReloadInfo(path, gg)
            rt._loader_kw = dict(use_quant=use_quant, **kw)
        return rt

    @property
    def recurrent(self) -> bool:
        """A model with recurrent state (the delta-net and mamba families),
        which a padded row must not advance and a cache row cannot be cut
        back."""
        return self.cfg.arch in RECURRENT_ARCHS

    @property
    def needs_n_valid(self) -> bool:
        """Padded prefill rows must not be committed to persistent state:
        recurrent state, and ring writes under --swa-compress (a padded row
        would wrap onto a live window row), as in the JAX runtime."""
        return self.recurrent or self.swa_compress

    @property
    def encoder_only(self) -> bool:
        """An encoder (the BERT family): hidden states out, no logits."""
        return self.cfg.arch in bert_mod.ARCHS

    @property
    def eos_id(self) -> int:
        return self.tokenizer.eos_id if self.tokenizer is not None else -1

    def new_cache(self, batch: int = 1, capacity: int = 512):
        # room for a bucket-padded write at the last row, rounded to 256
        # rows as the JAX runtime does (its decode kernel's tile rule), so
        # both runtimes hold the same cache rows
        b0 = max(PREFILL_BUCKETS[0], 256)
        capacity = -(-(capacity + PREFILL_BUCKETS[0] - 1) // b0) * b0
        quant = self.kv_quant
        if self.cfg.arch in RECURRENT_ARCHS:
            return CACHES[self.cfg.arch](self.cfg, batch, capacity, self.device, quant=quant)
        if self.cfg.arch in ds2_mod.ARCHS:
            # the latent cache where the model was loaded for it (bf16; the
            # JAX runtime gives this family no other cache type either)
            return ds2_mod.make_cache(self.cfg, batch, capacity, self.device,
                                      mla="wk_b" in self.params["blocks"][0], quant=quant)
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
        if self.swa_compress:
            # ring caches on the sliding-window layers, as the JAX runtime
            # makes them: bf16 only, and only where the ring is shorter than
            # the cache; otherwise the plain cache
            margin = PREFILL_BUCKETS[-1] + 64
            if (not quant and self.cfg.swa_window > 0
                    and self.cfg.swa_window + margin + 128 < capacity):
                return SwaKVCache.create(self.cfg, batch, capacity, self.device,
                                         margin=margin)
        return CACHES[self.cfg.arch](self.cfg, batch, capacity, self.device, quant=quant)

    def eval_tokens(self, ids: list[int], kv, n_past: int = 0, *,
                    all_logits: bool = False):
        """Evaluate ids in bucket-padded chunks; returns (logits, kv, n_past)
        with the logits of every position (all_logits) or of the last one,
        as a float32 (n, V) tensor on the runtime's device. A recurrent
        model's forward takes each chunk's live length (``n_valid``), so its
        state never sees the padding. An encoder has no logits: it raises."""
        if self.encoder_only:
            raise NotImplementedError(f"{self.cfg.arch} is an encoder with no LM head: it has "
                                      "no logits to evaluate; use Runtime.embed")
        fwd = FORWARDS[self.cfg.arch]
        out_chunks = []
        logits = None
        last_len = 0
        for i, n, tokens in _chunks(ids, kv, n_past, self.device):
            kw = {"n_valid": n} if self.needs_n_valid else {}
            logits = fwd(self.params, self.cfg, tokens, kv, n_past + i, **kw)
            if all_logits:
                out_chunks.append(logits[0, :n])
            last_len = n
        n_past += len(ids)
        if all_logits:
            return torch.cat(out_chunks, dim=0), kv, n_past
        return logits[0, last_len - 1:last_len], kv, n_past

    def reload_changed_tensors(self) -> bool:
        """Pick up on-disk tensor changes into the live model
        (llama_reload_changed_tensors, include/llama.h:1635;
        ``runtime/reload.py``). Needs ``from_gguf(..., track_reload=True)``."""
        from .reload import reload_changed_tensors
        return reload_changed_tensors(self)

    def all_position_logits(self, ids: list[int], capacity: int = 512) -> torch.Tensor:
        """The logits of every position of ``ids`` evaluated from a fresh
        cache, (n, V) float32 on the device: the perplexity tool's and the
        LoRA checks' call. The cache has room for the last chunk's padded
        write."""
        n = len(ids)
        rem = n % PREFILL_BUCKETS[-1] or PREFILL_BUCKETS[-1]
        capacity = max(capacity, (n - rem) + _bucket(rem))
        kv = self.new_cache(1, capacity)
        logits, _, _ = self.eval_tokens(ids, kv, 0, all_logits=True)
        return logits

    # ------------------------------------------------- hidden states ----
    def _padded(self, ids: list[int]):
        """ids as one (1, b) int64 chunk on the device, b the prefill bucket
        of len(ids) (len(ids) itself above the largest), and a fresh cache
        with room for it, as the JAX runtime's embed and layer_hiddens make
        them."""
        n = len(ids)
        b = _bucket(n) if n <= PREFILL_BUCKETS[-1] else n
        tokens = torch.zeros((1, b), dtype=torch.int64)
        tokens[0, :n] = torch.as_tensor(ids, dtype=torch.int64)
        return tokens.to(self.device), self.new_cache(1, max(b + 8, 64))

    def embed(self, ids: list[int], pooling: str = "mean",
              normalize: bool = True) -> np.ndarray:
        """Embedding extraction (llama_get_embeddings with the pooling types
        NONE / MEAN / CLS / LAST; examples/embedding): one forward over ids,
        padded to its bucket with the live length as ``n_valid``, for the
        final-norm hidden states. Returns a float32 numpy (E,) vector for a
        pooled mode, L2-normalized unless ``normalize`` is False, or the
        (T, E) states for pooling 'none'; any other pooling name means
        mean, as in the JAX runtime. The pooling runs in numpy on the host,
        as there."""
        n = len(ids)
        tokens, kv = self._padded(ids)
        hidden = FORWARDS[self.cfg.arch](self.params, self.cfg, tokens, kv, 0,
                                         return_hidden=True, n_valid=n)[0, :n]
        if pooling == "none":
            return hidden.cpu().numpy()
        if pooling == "cls":
            e = hidden[0].cpu().numpy()
        elif pooling == "last":
            e = hidden[-1].cpu().numpy()
        else:
            e = hidden.cpu().numpy().mean(axis=0)
        if normalize:
            e = e / (np.linalg.norm(e) + 1e-12)
        return e

    def layer_hiddens(self, ids: list[int]) -> torch.Tensor:
        """Every layer's output at each position of ids, (n_layer, T, E)
        float32 on the device: the control-vector generator's input. One
        forward over ids padded to its bucket."""
        n = len(ids)
        tokens, kv = self._padded(ids)
        hs = FORWARDS[self.cfg.arch](self.params, self.cfg, tokens, kv, 0,
                                     return_layer_hiddens=True, n_valid=n)
        return hs[:, 0, :n]

    def eval_probe(self, tokens, positions, block_mask, kv, n_past: int) -> torch.Tensor:
        """A tree / lookahead probe: a block of T tokens at explicit,
        possibly non-contiguous ``positions`` with an in-block visibility
        ``block_mask`` (T, T), the analogue of a multi-seq-id llama_batch
        (examples/lookahead/lookahead.cpp:182-259). Returns all T logit
        rows, (T, V) float32 on the device.

        The cache is written in place: the block's K/V rows land in rows
        n_past .. n_past + T - 1, overwriting what they held, and rows below
        n_past stay as they were, bit for bit. The caller's committed state
        is those rows below n_past; the JAX runtime leaves its cache
        untouched only because its arrays are immutable."""
        fwd = FORWARDS[self.cfg.arch]
        if fwd is not llama_mod.forward:
            raise NotImplementedError(f"eval_probe: arch {self.cfg.arch} uses a custom graph "
                                      "without block-mask support")
        t = len(tokens)
        if n_past + t > kv.capacity:
            raise ValueError(f"probe of {t} rows at n_past {n_past} past the cache's "
                             f"capacity {kv.capacity}")
        toks = torch.as_tensor(np.asarray(tokens, np.int64)[None], device=self.device)
        logits = fwd(self.params, self.cfg, toks, kv, n_past,
                     positions=torch.as_tensor(np.asarray(positions, np.int32)[None]),
                     block_mask=torch.as_tensor(np.asarray(block_mask, bool)))
        return logits[0]

    # ----------------------------------------------------- MTP (nextn) ----
    @property
    def has_mtp(self) -> bool:
        return "mtp_blocks" in self.params

    def new_mtp_cache(self, batch: int = 1, capacity: int = 512) -> KVCache:
        """The 1-layer bf16 KV cache of the trailing NextN/MTP layer on the
        runtime's device, with room for a bucket-padded write at its last
        row."""
        b0 = max(PREFILL_BUCKETS[0], 256)
        capacity = -(-(capacity + PREFILL_BUCKETS[0] - 1) // b0) * b0
        return KVCache.create(replace(self.cfg, n_layer=1), batch, capacity, self.device)

    def mtp_eval(self, ids: list[int], hidden: torch.Tensor, kv: KVCache, n_past: int):
        """Run the MTP layer over (token, main hidden) pairs in bucket-padded
        chunks: the warm-up over a prompt, and the refresh of accepted rows
        (mtp_update_kv_cache). ``hidden`` (n, E). Returns (the last pair's
        logits (V,), its MTP hidden (E,), kv, n_past)."""
        logits = h_out = None
        j = 0
        for i, n, tokens in _chunks(ids, kv, n_past, self.device):
            hid = torch.zeros((1, tokens.shape[1], hidden.shape[-1]), dtype=torch.float32,
                              device=self.device)
            hid[0, :n] = hidden[i:i + n].to(self.device)
            logits, kv, h_out = llama_mod.mtp_forward(self.params, self.cfg, tokens, hid, kv,
                                                      n_past + i)
            j = n - 1                     # the last real position of this chunk
        n_past += len(ids)
        if logits is None:
            return None, None, kv, n_past
        return logits[0, j], h_out[0, j], kv, n_past

    def eval_tokens_hidden(self, ids: list[int], kv, n_past: int = 0):
        """eval_tokens with the pre-output-norm hidden state of every
        position (the MTP layer's input, 'result_mtp_embd'). Returns
        (logits (n, V), hidden (n, E) f32, kv, n_past) on the device."""
        fwd = FORWARDS[self.cfg.arch]
        if fwd is not llama_mod.forward:
            raise NotImplementedError(f"the MTP hidden of arch {self.cfg.arch!r}: only "
                                      "the llama graph carries NextN/MTP layers")
        out_l, out_h = [], []
        for i, n, tokens in _chunks(ids, kv, n_past, self.device):
            logits, hid = fwd(self.params, self.cfg, tokens, kv, n_past + i,
                              return_mtp_hidden=True)
            out_l.append(logits[0, :n])
            out_h.append(hid[0, :n])
        return torch.cat(out_l), torch.cat(out_h), kv, n_past + len(ids)

    # ------------------------------------------------- speculative verify ----
    def _spec_verify(self, width: int):
        """The greedy verify step: ``step(tokens (B, W), kv, n_past)`` runs
        the block at T = W, with no bucket padding, so that W <= 16 stays on
        the decode attention kernel; it writes the block's W rows at n_past
        in place and returns the argmax of every position, (B, W) int64 on
        the device, so that a caller reads back W ints a row and never the
        (W, V) logits. Rejected rows need no rollback: n_past stays behind
        them and the next step overwrites them."""
        fwd = FORWARDS[self.cfg.arch]

        def step(tokens: torch.Tensor, kv, n_past):
            if tokens.shape[1] != width:
                raise ValueError(f"verify block of width {tokens.shape[1]}, not {width}")
            logits = fwd(self.params, self.cfg, tokens.to(self.device), kv, n_past)
            return torch.argmax(logits, dim=-1)

        return step

    def _spec_loop(self, width: int, rounds: int, *, draft: str = "ngram",
                   ngram_n: int = 4, table_bits: int = 16):
        """``rounds`` greedy draft + verify rounds a call, the drafter on the
        device: the JAX runtime's ``_spec_loop``, with the rounds driven
        from the host. The JAX loop runs them in one jit; the port's cache
        writes slice by the host ``n_past``, so each round reads back one
        small int tensor (the verify's W argmaxes beside the W - 1
        proposals). The hash table and the replay buffer stay on the
        device, and the tokens, per-round counts and table are the JAX
        loop's.

        draft="ngram": an int32 table of 2**table_bits entries indexed by an
        FNV-1a hash of the last ``ngram_n`` tokens, holding the token that
        followed; a proposal chains W - 1 lookups, a miss proposes 0, and
        every emitted token is inserted after its window.
        draft="replay": the proposals stream from a continuation buffer
        (padded with -1, which is always rejected).

        Returns a callable:
          ngram:  (table, win, cur, kv, n_past) -> (buf, counts, table, win, cur, kv, n_past)
          replay: (replay, pos, cur, kv, n_past) -> (buf, counts, pos, cur, kv, n_past)
        where buf (rounds * W,) int32 holds the sum(counts) new tokens
        first, then -1, and counts (rounds,) int32 is each round's
        emission count (1 + accepted); ``cur``, ``pos`` and ``n_past`` are
        host ints."""
        if self.recurrent:
            raise NotImplementedError(
                "the speculative loop needs a positional KV rewind; a recurrent model "
                "takes generate_speculative")
        if draft not in ("ngram", "replay"):
            raise ValueError(f"unknown device draft kind {draft!r}")
        w = width
        verify = self._spec_verify(w)
        dev = self.device

        def round_(cur: int, proposal: torch.Tensor, kv, n_past: int):
            """One verify of [cur | proposal]: the tokens it emits."""
            # a -1 proposal is rejected at its position, so what the model
            # reads there never reaches an emitted token
            block = torch.cat([torch.tensor([cur], dtype=torch.int64, device=dev),
                               proposal.clamp(min=0)])[None]
            preds = verify(block, kv, n_past)[0]
            host = torch.cat([preds, proposal]).tolist()       # the one readback
            preds, prop = host[:w], host[w:]
            n_acc = 0
            while n_acc < w - 1 and preds[n_acc] == prop[n_acc]:
                n_acc += 1
            return preds[:n_acc + 1]

        def finish(emitted: list):
            buf = torch.full((rounds * w,), -1, dtype=torch.int32)
            flat = [t for em in emitted for t in em]
            buf[:len(flat)] = torch.tensor(flat, dtype=torch.int32)
            return buf, torch.tensor([len(em) for em in emitted], dtype=torch.int32)

        if draft == "ngram":
            def loop(table, win, cur, kv, n_past):
                win_h = [int(t) for t in win.tolist()]
                emitted = []
                for _ in range(rounds):
                    wd = torch.tensor(win_h, dtype=torch.int64, device=dev)
                    props = []
                    for _ in range(w - 1):
                        t = table[ngram_hash(wd, table_bits)].clamp(min=0).to(torch.int64)
                        props.append(t)
                        wd = torch.cat([wd[1:], t[None]])
                    proposal = (torch.stack(props) if props
                                else torch.zeros(0, dtype=torch.int64, device=dev))
                    em = round_(cur, proposal, kv, n_past)
                    upd = {}
                    for tok in em:                 # insert each emitted token
                        upd[ngram_hash(win_h, table_bits)] = tok
                        win_h = win_h[1:] + [tok]
                    table[torch.tensor(list(upd), device=dev)] = torch.tensor(
                        list(upd.values()), dtype=table.dtype, device=dev)
                    emitted.append(em)
                    cur = em[-1]
                    n_past += len(em)
                buf, cs = finish(emitted)
                return (buf, cs, table, torch.tensor(win_h, dtype=win.dtype, device=win.device),
                        cur, kv, n_past)
        else:
            def loop(replay, pos, cur, kv, n_past):
                emitted = []
                for _ in range(rounds):
                    em = round_(cur, replay[pos:pos + w - 1].to(torch.int64), kv, n_past)
                    emitted.append(em)
                    cur = em[-1]
                    pos += len(em)
                    n_past += len(em)
                buf, cs = finish(emitted)
                return buf, cs, pos, cur, kv, n_past
        return loop

    def generate(self, prompt, max_new_tokens: int = 32,
                 sampler: SamplerParams | None = None, seed: int = 0,
                 capacity: int = 512, stop_at_eos: bool = True):
        """Greedy generation (no sampler, or temp 0) or sampled through the
        host sampler chain with ``np.random.default_rng(seed)``, one
        eval_tokens call per token. Returns (prompt_ids, generated_ids)."""
        ids = self._ids(prompt)
        kv = self.new_cache(1, capacity)
        logits, kv, n_past = self.eval_tokens(ids, kv, 0)
        rng = np.random.default_rng(seed)
        state = SamplerState()
        out = []
        for _ in range(max_new_tokens):
            if sampler is None:
                tok = int(torch.argmax(logits[-1]))
            else:
                tok = int(sample_token(logits[-1].cpu().numpy(), sampler, rng,
                                       history=ids + out, state=state))
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
        forward = FORWARDS[self.cfg.arch]
        for s in range(n_steps):
            logits = forward(self.params, self.cfg, tok, kv, n_past + s,
                             npv=pos[s:s + 1].expand(b), logits_last_only=True)
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

    def _ids(self, prompt) -> list[int]:
        """Token ids of a prompt: a str is encoded with the tokenizer (BOS
        by its rule), a sequence of ids is taken as it is."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("this runtime has no tokenizer: pass token ids")
            return self.tokenizer.encode(prompt)
        return [int(t) for t in prompt]

    def detokenize(self, ids) -> str:
        return self.tokenizer.decode([int(t) for t in ids])
