#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases 1,2,3,...,25]

Phases (all by default; any failure exits non-zero):
  1. device: the card's name and power limit; TF32 off for the plain versions
  2. build: every kernel under ik_llama_cpp_tpu_torch/csrc with nvcc
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with its error, tolerance, time, the plain
     version's time, a library call's time and the card's bound (times
     after a flush that leaves the L2 clean; kernels A, 8, 10 and 13 and
     their library calls also under the older zero_() flush), the launch
     plan of kernels 8 and 13 and their time by columns a block, the K
     split of kernels A, D and 15 at M <= 16 against their time, kernel
     12's plan and its time by columns a block (kernel 7's the same),
     kernel 10 held to its plain version's bits with its time by tokens a
     sweep, kernel 6's time by query
     heads a block (rows 6L and 2L: the last chunk of phase 9's long fill
     over a q8 and a bf16 cache), kernel A's host cost a call at M = 1,
     the tile widths of the tiled A, D and 15 at M = 512 against their
     time, and the warpgroup MMAs of the three tiled kernels in their
     SASS; the split plans of the decode
     attention kernels C and 5 and kernel 14's work plan beside their
     cases. With phase 12 also run, row 14p follows it: kernel 14 at the
     group sizes phase 12's router gave (the layer-0 call against its
     plain version and library call, every layer's call timed alone);
     with phase 7, rows 9p and 10p: kernel 9 at its router's buckets and
     kernel 10 at their overflow, the same way
  4. end to end at full width (L32 E4096 H32 KV8 FF14336 V32000, Q4_0
     planar weights, Q8_0 tied head, random weights from a seed): load
     through Runtime.from_gguf, prefill 512 tokens, decode 64 greedily,
     with every kernel launch counted; then a torch.profiler view of 8
     more decode steps (device time by kernel, busy share) and of one
     prefill chunk (kernels A and B)
  5. parity at depth 2: kernel path against the plain path on the card,
     identical greedy tokens over 16 steps
  6. planar path (int8 path off: every linear a QLinear, kernel D): at
     depth 2 the launch check and the kernel path against the plain path
     over one token history (every step's logits); then the same file
     cloned to the full width of phase 4 (L32): prefill 512, decode 64,
     launch counts, a decode profile (the M <= 16 kernel a step, the idle
     share) and a prefill profile (the tiled kernel)
  7. MoE end to end at the full width of Qwen3-30B-A3B (E2048 H32 KV4
     D128, 128 experts top-8 FF768, V151936, at 16 of its 48 layers, L7;
     Q4_0 attention and experts,
     Q8_0 embedding and untied head, random blocks from a seed): load,
     prefill 512, decode 64, with every kernel launch counted, then the
     decode profile (kernels 7's and 8's share of a step) and a prefill
     chunk's (kernels 9 and 10; it fails if 10 launched but shows no time)
  8. MoE parity at depth 2: kernel path against the plain path on the card
  9. quantized KV cache end to end at the full width of phase 4 (8 of its
     32 layers, L9): q8 (prefill 512, decode 64, launch counts, decode profile), then q4, q6, nl4, q8
     with the K/V Hadamard rotation and a per-layer codec dict on the same
     weights; a q8 cache and a bf16 one of capacity 4,096 filled with 3,999
     tokens by the prefill chunks (profiled: kernel 6's ms over the q8
     fill beside kernel B's over the bf16 one), 8 decode steps at ~4,000
     keys profiled (kernel 5's ms a step beside kernel C's); and one
     K-shift on the q8 cache followed by more decode steps
 10. quantized-KV parity at depth 2: per codec, kernel path against plain
     path over one token history (the plain path is fed the kernel path's
     greedy tokens): logits at every step, where the greedy picks differ,
     and the cache codes the two wrote
 11. 4-bit packed weights (set_pack_int4) at full width: every block linear
     a QLinearI4, prefill 512, decode 64, launch counts, a decode profile
     (kernel 15's M <= 16 kernel a step), a prefill profile (its tiled
     kernel's share), parity at depth 2
 12. planar / mixed-format MoE end to end at the full width of
     Qwen1.5-MoE-A2.7B (qwen2moe: L24 E2048 H16 KV16 D128, q/k/v biases, 60
     experts top-4 FF1408, a shared expert of FF5632 with a sigmoid gate,
     V151936; Q4_0 attention, experts and shared expert, Q8_0 embedding and
     untied head, random blocks from a seed): gate/up experts re-coded per
     supergroup of 256, down experts planar group 32 (1408 % 256 != 0);
     load, prefill 512, decode 64, launch counts, decode and prefill profiles
     (kernel 13's share of a decode step, kernel 14's of a prefill chunk),
     and the group sizes the router gives kernel 14 in a chunk
 13. parity at depth 2, kernel path against plain path over one token
     history, for (a) the phase-12 model, (b) the Qwen3-30B-A3B shape with
     the int8 path off (every expert projection planar) and (c) the same
     shape with the single-kernel decode (IK_MOE_FUSED_TG=1)
 14. the single-kernel MoE decode at the full width of Qwen3-30B-A3B
     (IK_MOE_FUSED_TG=1 on phase 7's loaded model): decode 64, launch
     counts, the kernel time a step beside phase 7's two-kernel step
 15. the dequant microbenchmark tool (tools/perf_dequant) at its default
     shape: the planar GEMM with f32 and bf16 scales, its pair form, and a
     bf16 torch.matmul
 16. the text-serving path at the full width of phase 4 (its file carries a
     SentencePiece vocabulary of 32,000 pieces): a BatchEngine of 4 slots
     over one bf16 cache answers six text requests at once through the
     Server's request methods (no HTTP): prompts of 20 to 600 tokens, three
     greedy (one with a stop string, one streamed) and three sampled (one
     a chat through the built-in llama-3 template); the launches of kernels
     A, B and C counted over the run, requests/s and tokens/s over all
     slots, and each greedy request replayed at B = 1 on the kernel path
     and the plain path over its own history. Then 16b on the same loaded
     model: slot state (a ~1,000-token prompt saved, the slot erased and
     overwritten, restored: its rows bit for bit, the restored tokens
     counted as cached, an extending request's greedy tokens those of the
     uninterrupted slot; save and restore ms and GB/s; again over a q8
     cache, where kernels 5 and 6 read the restored rows), then the
     request options, each gated on the model's own unconstrained greedy
     run: banned words with a rewind, the reasoning budget, a lazy
     grammar, a forced tool call, the allowlist, an expiring bias,
     post-sampling probabilities and the Anthropic API
 17. the llama-graph family: Gemma-3-12B at full width (gemma3: E3840
     H16 KV8 D256 FF15360, V262208 tied, a 1,024-key window on all layers
     but each sixth, QK-norms, sandwich norms, GELU; Q4_0 linears, a Q8_0
     embedding, random blocks from a seed, one block cloned to 8 of its 48
     layers, L17): a 3,999-token prefill in
     chunks and 64 greedy decode steps at 4,000 cached tokens, with the
     A/B/C launch counts and a decode profile; the same decode over
     --swa-compress ring caches (cache bytes against the full cache, the
     plain ring attention's ms a step); then one-history parities of the
     kernel path against the plain path: Gemma-3-12B at depth 6 over 1,100
     tokens, the Gemma-2-9B width (softcaps 50 / 30) and the gpt-oss-20b
     width (sinks, router and expert biases, planar experts) at depth 2.
     Phase 3 adds kernel A at the Gemma-3-12B shapes and kernels B and C at
     head dim 256 with a 1,024-key window and softcap 50
 18. the DeepSeek-2 family: DeepSeek-V2-Lite at full width (deepseek2: L27
     E2048 H16, kv-lora 512, nope 128 / rope 64 / v 128, 64 experts top-6
     FF1408 softmax-routed, 2 shared experts, a dense lead of FF10944,
     V102400, YaRN 40; Q4_0 linears and experts, Q8_0 embedding and head,
     random blocks from seed 0, its MoE block cloned to 15 layers: 16 of
     its 27) on the MLA latent cache: the load, a 3,999-token prefill in chunks and 64
     greedy decode steps at 4,000 cached tokens, the launches a step by
     kernel (the MLA form of kernel B 16 a chunk and 16 a step), decode and
     prefill profiles, the cache's bytes beside the per-head cache's, two
     greedy requests on a 2-slot BatchEngine replayed at B = 1; then
     one-history parities at depth 2: (a) those widths, (b) DeepSeek-V3's
     routing (sigmoid, selection bias, normalized top-k, scale 2.5) with a
     1536 q-lora, (c) mla=False, (d) glm-dsa's lightning indexer (64 heads
     of 128, top-k 2,048) over 2,100 tokens. Phase 3 adds rows 2m, 2md and
     2md2 (the MLA form's wgmma kernel at the last chunk of that fill, its
     decode kernel at the decode step after it and at two slots, with the
     decode kernel's key splits against its time), 2m128 and 2md128 (the
     same at DeepSeek-V3's 128 heads) and 2k (kernel B at the mla=False
     heads)
 19. the hybrid gated-delta-net family: Qwen3-Next-80B-A3B at full width
     (qwen3next: E2048, attention every 4th layer with 16 gated q heads over
     2 kv heads of 256 and rope on 64 dims, delta-net layers of 16 k / 32 v
     heads of 128 with conv kernel 4, 512 experts top-10 of FF 512 and a
     sigmoid-gated shared expert, V151936; Q4_0 linears and experts, Q8_0
     embedding and head, random blocks from seed 0; four blocks, three
     delta-net and one attention, cloned to 8 layers) on the recurrent
     HybridCache: a 1,024-token prefill in two chunks, 64 greedy decode
     steps, the launches of kernels A, B, C, 7, 8, 9 and 10 a chunk and a
     step, decode and prefill profiles, the delta-net recurrence's eager ms
     a step (device and host), two greedy requests on a 2-slot BatchEngine
     (the second submitted while the first decodes) replayed at B = 1, and
     a one-history parity at depth 4, and a speculative check: the host
     loop of generate_speculative with a drafter wrong at the third token
     of every proposal, whose state after the rollbacks equals the same
     chunks evaluated plainly (and the checkpoint clone's ms). Phase 3 adds
     kernel A at the model's linears and rows 2q and 3q (B and C at 16 / 2
     heads of 256); with phase 3 also run, row 9q follows: kernel 9 at the
     router's buckets
 20. speculative decoding on the dense path at the full width of phase 4
     (L32; it builds phase 4's file when phase 4 did not): a 512-token
     prompt and 64 new tokens, (a) plain greedy, (b) generate_speculative
     with ReplayDraft of (a)'s tokens at n_draft 4 and 8, (c) the ngram
     stage at 8, (d) generate_speculative_device (the device ngram table;
     replay), (e) a 4-slot BatchEngine with spec="ngram", spec_n=8 against
     the same engine without it, (f) one replay round over a q8 cache;
     the launches of (a)-(f), each run's tokens held to the plain path over
     their own history (within 5% of the plain step's largest |logit|, the
     exact argmaxes counted), tok/s, acceptance, wall and host ms a round,
     and the verify's device ms and launches at each width. Phase 3 holds
     each kernel at the shapes that phases 19-21 give it: rows 1s (A at M
     5, 9 and 36), 3s (C at T 5 and 9, and B = 4 x 9; at GLM-4.5-Air's 96
     / 8 heads T 1, 8 and 16; Qwen3-Next's T 8), 5s (5 at T 9), and at
     GLM-4.5-Air's widths 1a / 1m (A), 4a (D), 2a (B), 12a / 13a (the
     planar decode chain at P 8 and 64), 10a / 14a (the sorted chain at
     128 and 4,096 pairs)
 21. the NextN/MTP layer at GLM-4.5-Air's full width (glm4moe: E4096, 96
     / 8 heads of 128 with q/k/v biases, rope on 64 dims, a dense first
     layer of FF 10944, 128 experts top-8 of FF 1408 with sigmoid routing
     and a selection bias, a shared expert, V151552; Q4_0 linears and
     experts, Q8_0 embedding and head, random blocks from seed 0): the
     dense layer, 3 MoE layers (one block cloned) and the MTP layer; plain
     greedy and generate_speculative(stage="mtp") at n_draft 3 and 8 over
     a 512-token prompt and 48 new tokens, and at 3 with its drafts forced
     to the plain continuation (the refreshed MTP cache rows against a
     fresh evaluation), the launches, the one-history gate, the verify's
     and the MTP draft step's device ms and launches, and the MTP layer's
     logits and hidden against the plain path on the same main hiddens
 22. the mamba family: Mamba-2.8B at full width (state-spaces/mamba-2.8b-hf:
     E2560, d_inner 5120, state 16, conv 4, dt rank 160, V50280 tied; Q4_0
     ssm_in / ssm_out, a Q8_0 tied embedding, f32 conv, ssm_x, ssm_dt, A, D
     and norms, random from seed 0; one block cloned to 32 of its 64
     layers, L22) on the
     recurrent MambaCache: a 512-token prefill and 64 greedy decode steps
     with every kernel launch counted (A 129 a chunk and a step), decode
     and prefill profiles, the scan's device and host ms a layer, peak
     memory; a one-history parity against the plain path; a padded chunk's
     state against the unpadded chunk's, bit for bit; two greedy requests on
     a 2-slot BatchEngine, each held to the runtime's greedy tokens;
     generate_speculative with a replay draft (its tokens the plain greedy
     ones) and with a drafter wrong at the third token (the checkpoint's
     restore). Phase 3 adds row 1b: kernel A at ssm_in, ssm_out and the
     tied head, M 1 and 512
 23. LoRA and perplexity on the dense path at the full width of phase 4
     at 16 of its 32 layers (L23, loaded with q/k/v and gate/up unfused): a
     rank-16, alpha-32 adapter on all seven projections of every layer
     (written by runtime/lora.write_lora_gguf, random from seed 23): prefill
     512 and 64 decode steps with it (A 7 x L23 + 1 a step), A's kernel ms beside the low-rank
     products' ms a step (a profiled step with the adapter less one without); a one-history parity of the adapted kernel path
     against the adapted plain path; at scale 0 and after strip_lora the
     logits equal the unadapted model's bit for bit, and the adapter moves
     them by more than 1% of the largest logit; a Server with --lora
     answering GET /lora-adapters, a completion, POST scale 0 and a
     completion that equals the base model's; compute_perplexity over
     smoke_text at n_ctx 512 with and without the adapter, the adapted
     kernel path within 2% of the adapted plain path; then, on the same
     loaded model with the adapter stripped, the hidden-state paths:
     layer_hiddens over 512 tokens (A 7 x L23, B L23), generate_control_vector
     over 4 prompt pairs, the embedding of a 300-token input padded to its
     bucket of 512 (n_valid) against the plain path, and lookahead decoding
     (W 4, N 3, G 4) over 64 tokens: a free run, and the one-history gate
     (fed greedy decode's tokens, each probe row on the greedy history
     within 5% of the decode step's logits at its position) with the
     accepted tokens a round
 24. the BERT encoder family: BGE-M3 at full width and depth (bert L24
     E1024 H16 FF4096, V250002, 8,192 positions, CLS pooling; Q4_0 linears,
     a Q8_0 embedding, random from seed 0, every layer its own) through
     Runtime.embed over documents of 7, 100, 512, 2,048 and 8,192 token
     ids: tok/s and A 144 a forward exactly, profiles of the 512- and
     8,192-token forwards (kernel A against the plain attention, wall,
     idle share), peak memory, the kernel path against the plain path
     layer by layer over one history (each layer within 1% of the largest
     state) and run free over 512 tokens (the pooled and per-position unit
     vectors within BGE_FREE_TOL and BGE_ROW_TOL, and pooled within
     BGE_WITNESS_X times the plain path against itself with one bf16
     rounding flipped a layer), and
     the server's /v1/embeddings, /embedding and /rerank on the encoder,
     each vector and score Runtime.embed's bit for bit. Phase 3 adds rows
     1e: kernel A at BGE-M3's three shapes at M 512 and 8,192
 25. the multimodal path on phase 16's loaded L32 model (the dense bench
     widths, LLaVA-1.6-Mistral-7B's text tower): (a) an f16 mmproj at CLIP
     ViT-L/14-336's widths (23 blocks, the llava mlp projector to 4096) and
     a 640 x 480 PNG made in the phase, (b) an f16 mmproj at
     whisper-large-v3's encoder widths with Qwen2-Audio's qwen2a projector
     and 29.5 s of 16 kHz PCM16 WAV (one chunk, 750 rows); each a chat
     through Server.oai_chat (--mmproj's load_mmproj, generate_mm on the
     engine's loop thread), the encoder on the card against the CPU in
     float32, the splice prefilled by rows and decoded with the launches
     of A, B and C a chunk and a step, rows/s, tok/s, peak GiB, and the
     one-history parity of the splice and its greedy tokens; then the
     profiler routes around one request (the Chrome trace names kernel
     A), and Runtime.reload_changed_tensors on an L2 file at the bench
     widths (one ffn_down overwritten: a fresh load's logits bit for bit).
     Phase 17 adds a 2-slot BatchEngine over its ring caches (tokens held
     to the runtime's ring tokens, a prefix past the window reused);
     phase 3's kernel 9 rows (9, 9p, 9q) each repeat REPEAT_CALLS calls
     bit for bit
The line before the last lists every ported kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core ops/s
BF16_FLOPS = 989e12        # dense bf16 tensor-core flop/s
E, H, HKV, FF, V, NL = 4096, 32, 8, 14336, 32000, 32
D = E // H
PREFILL, DECODE = 512, 64
GGUF_VERSION = "port-2"
# Qwen3-30B-A3B (the published config.json of Qwen/Qwen3-30B-A3B)
MOE = dict(ARCH="qwen3moe", L=48, E=2048, H=32, HKV=4, D=128, G=128, TOPK=8, FF=768,
           V=151936)
MOE_GGUF_VERSION = "port-4"
# Qwen1.5-MoE-A2.7B (the published config.json of Qwen/Qwen1.5-MoE-A2.7B):
# 1408 % 256 != 0, so its down experts stay planar beside supergroup gate/up
Q2MOE = dict(ARCH="qwen2moe", L=24, E=2048, H=16, HKV=16, D=128, G=60, TOPK=4, FF=1408,
             FFS=5632, V=151936)
# kernel A's (K, N) on the two MoE paths: Qwen3-30B-A3B's fused qkv, head
# and wo; Qwen1.5-MoE-A2.7B's fused qkv, q/k/v/wo, shared gate/up and down
A_MOE_SHAPES = [(2048, 5120), (2048, 151936), (4096, 2048), (2048, 6144), (2048, 2048),
                (2048, 11264), (5632, 2048)]
# Gemma-3-12B (the text_config of google/gemma-3-12b-pt's config.json): 48
# layers, a 1,024-key window on every layer but each sixth, head dim 256,
# rope base 10,000 on the window layers and 1,000,000 scaled linearly by 8
# on the global ones, QK-norms, sandwich norms, GELU, a tied head
GEMMA3 = dict(ARCH="gemma3", L=48, E=3840, H=16, HKV=8, D=256, FF=15360, V=262208,
              WINDOW=1024, CTX=131072, ROPE=1000000.0, ROPE_SCALE=8.0)
# Gemma-2-9B (google/gemma-2-9b's config.json): a 4,096-key window on even
# layers, attention softcap 50, final softcap 30
GEMMA2 = dict(ARCH="gemma2", L=42, E=3584, H=16, HKV=8, D=256, FF=14336, V=256000,
              WINDOW=4096, CTX=8192, ROPE=10000.0, SOFTCAP=50.0, FINAL_SOFTCAP=30.0)
# gpt-oss-20b (openai/gpt-oss-20b's config.json): 32 experts top-4 with
# router and expert biases, clamped SwiGLU, per-head sinks, a 128-key window
# on even layers, yarn rope (factor 32 over 4,096), an untied head
GPTOSS = dict(ARCH="gpt-oss", L=24, E=2880, H=64, HKV=8, D=64, G=32, TOPK=4, FF=2880,
              V=201088, WINDOW=128, CTX=131072, ROPE=150000.0)
FAMILY_GGUF_VERSION = "port-17"
# kernel A's (K, N) on the Gemma-3-12B path: fused qkv, wo, fused gate/up,
# down and the tied head (262,208 = 2,048 * 128 + 64 columns)
A_GEMMA_SHAPES = [(3840, 8192), (4096, 3840), (3840, 30720), (15360, 3840), (3840, 262208)]
# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite's config.json): 27 layers,
# hidden 2048, 16 heads, kv_lora_rank 512 and no q-lora, qk_nope 128 /
# qk_rope 64 / v 128, 64 routed experts top-6 of FF 1408 with softmax
# routing and unnormalized weights, 2 shared experts, one leading dense
# layer of FF 10944, vocab 102400, YaRN factor 40 over 4,096 positions with
# mscale_all_dim 0.707 (GGUF's yarn_log_multiplier 0.0707), rope base 10,000
DSV2 = dict(ARCH="deepseek2", TAG="dsv2lite", L=27, E=2048, H=16, NOPE=128, ROPE=64, DV=128,
            LORA_KV=512, LORA_Q=0, G=64, TOPK=6, FF=1408, NSH=2, FFD=10944, V=102400,
            GATING=1, NORM=False, SCALE=1.0, BIAS=False)
# (b) DeepSeek-V3's routing at the V2-Lite widths: sigmoid gating, a
# selection bias, normalized top-k weights scaled by 2.5, a q-lora of 1536
DSV3R = dict(DSV2, TAG="dsv3route", LORA_Q=1536, GATING=2, NORM=True, SCALE=2.5, BIAS=True)
# (d) glm-dsa at the same widths: (b)'s routing and q-lora, the pre-split
# attn_k_b / attn_v_b, and the lightning indexer (64 heads of 128, top-k
# 2,048) on every layer
GLMDSA = dict(DSV3R, ARCH="glm-dsa", TAG="glmdsa", IDX_H=64, IDX_D=128, IDX_K=2048)
DS_GGUF_VERSION = "port-18"
LONG18, DECODE18 = 4000, 64      # phase 18's cached tokens and decode steps
# Qwen3-Next-80B-A3B (Qwen/Qwen3-Next-80B-A3B-Instruct's config.json): 48
# layers, hidden 2048, full attention every 4th layer with 16 gated q heads
# over 2 kv heads of 256 (rope on 64 dims, partial_rotary_factor 0.25, base
# 1e7), gated delta-net linear attention on the others (16 k heads / 32 v
# heads of 128, conv kernel 4), 512 experts top-10 of FF 512 and a
# sigmoid-gated shared expert of FF 512, vocab 151,936, an untied head.
# Phase 19 runs it at 8 layers: the int8 experts take ~1.64 GB a layer
QNEXT = dict(ARCH="qwen3next", L=48, LRUN=8, E=2048, H=16, HKV=2, D=256, ROPE_DIM=64,
             ROPE=1e7, HK=16, HV=32, DK=128, DV=128, CONV=4, G=512, TOPK=10, FF=512,
             FFS=512, V=151936, CTX=262144)
QNEXT_GGUF_VERSION = "port-20"
PREFILL19, DECODE19 = 1024, 64   # phase 19's prefill (two chunks) and decode steps
# phases 7 and 17 run their models' published widths at 16 and 8 of their
# 48 layers, and phase 19 at 8, so that the whole script stays inside its
# time limit on a slow host (with 7 and 17 at 24 layers and 19 at 24 a full
# run took 977-993 s of its 1,200 on an H100 80GB HBM3 at 700 W, and 1,296 s
# on a host ~30% slower; at 12 phase 19 took 108-118 s; with 17 at 16 and
# phase 16b added, 1,079 s on a slow host)
L7 = 16
L17 = 8
# phase 9 runs the dense model's published width at 8 of its 32 layers
# over every KV codec (at 32 it took 148-201 s of a full run, at 16 103 s)
L9 = 8
# phase 18 runs DeepSeek-V2-Lite at 16 of its 27 layers (the dense lead
# and 15 MoE layers), which makes room for phase 23's additions and phase 24
L18 = 16
# kernel A's (K, N) on the Qwen3-Next path: ssm_in, the gated wq, ssm_out
# (and wo), the head, wk / wv and the shared expert's gate / up, its down
A_QNEXT_SHAPES = [(2048, 12288), (2048, 8192), (4096, 2048), (2048, 151936), (2048, 512),
                  (512, 2048)]
DSV3_H = 128                     # DeepSeek-V3's query heads over the same 576 / 512 latent head
# phase 20: speculative decoding on the dense model of phase 4
SPEC_PROMPT, SPEC_NEW = 512, 64
# GLM-4.5-Air (zai-org/GLM-4.5-Air's config.json): 46 layers, hidden 4096, 96
# heads over 8 kv heads of 128 with q/k/v biases and no QK-norm, rope on 64
# dims (partial_rotary_factor 0.5, base 1e6), a dense first layer of FF
# 10944 (first_k_dense_replace 1), then 128 routed experts top-8 of FF 1408
# with sigmoid routing, a selection bias (e_score_correction_bias) and
# normalized weights, one shared expert of FF 1408, vocab 151,552, an untied
# head, and one NextN/MTP layer (num_nextn_predict_layers 1). Phase 21 runs
# the dense layer, LRUN - 1 MoE layers and the MTP layer: an int8 MoE layer
# takes ~2.3 GB
GLM_AIR = dict(ARCH="glm4moe", L=46, LRUN=4, E=4096, H=96, HKV=8, D=128, ROPE_DIM=64,
               ROPE=1e6, FFD=10944, G=128, TOPK=8, FF=1408, FFS=1408, V=151552, CTX=131072)
GLM_GGUF_VERSION = "port-21"
GLM_PROMPT, GLM_NEW = 512, 48    # phase 21's prompt and new tokens
# kernel A's (K, N) on GLM-4.5-Air's int8 path: wq, wk / wv, wo, the dense
# layer's fused gate|up, the shared expert's gate and up, the head, eh_proj
A_GLM_SHAPES = [(4096, 12288), (4096, 1024), (12288, 4096), (4096, 2 * 10944), (4096, 1408),
                (4096, 151552), (8192, 4096)]
# the rows of phase 21's verify chunks: W = 4 and 9 padded to 8 and 16
GLM_VERIFY_ROWS = (8, 16)
# Mamba-2.8B (state-spaces/mamba-2.8b-hf's config.json): 64 layers, hidden
# 2560, expand 2 (d_inner 5120), state 16, conv kernel 4, dt rank 160
# (hidden / 16), rms eps 1e-5, vocab 50,280, tied embeddings
MAMBA = dict(ARCH="mamba", L=64, E=2560, DI=5120, DS=16, CONV=4, DTR=160, V=50280,
             EPS=1e-5)
MAMBA_GGUF_VERSION = "port-22"
# phase 22 runs Mamba-2.8B at 32 of its 64 layers (at 64 it took 56-87 s
# of a full run)
L22 = 32
# phase 23 runs the dense model's published width at 16 of its 32 layers
# (at 32 it took 117-126 s of a full run on a slow host)
L23 = 16
# kernel A's (K, N) on the Mamba-2.8B path: ssm_in, ssm_out, the tied head
A_MAMBA_SHAPES = [(2560, 10240), (5120, 2560), (2560, 50280)]
# phase 23's adapter on the dense model of phase 4: rank and alpha
LORA_RANK, LORA_ALPHA = 16, 32.0
# phase 23's lookahead window (W columns, N-gram size, G verification grams)
# and its new tokens
LOOKAHEAD_WNG, LOOKAHEAD_NEW = (4, 3, 4), 64
# BGE-M3 (BAAI/bge-m3's config.json: XLMRobertaModel, hidden 1024,
# intermediate 4096, 16 heads, 24 layers, vocab 250,002, 8,194 positions of
# which a GGUF keeps the 8,192 after XLM-R's padding offset of 2, one token
# type, LayerNorm eps 1e-5, GELU, CLS pooling), arch bert in GGUF
BGEM3 = dict(ARCH="bert", L=24, E=1024, H=16, FF=4096, V=250002, CTX=8192, TYPES=1, EPS=1e-5)
BERT_GGUF_VERSION = "port-24"
EMBED_LENGTHS = (7, 100, 512, 2048, 8192)    # phase 24's documents, in tokens
# phase 24's free run over 512 tokens: the L2 distance of the kernel path's
# pooled unit vectors (mean and first position) from the plain path's, and
# of one position's. 24 post-LN layers of random weights grow a layer's
# 0.2-0.8% gap (the one-history gate) to 0.034-0.038 pooled and 0.038 at
# the worst position on an H100 80GB HBM3 at 700 W; the plain path against
# itself with one bf16 rounding flipped a layer, the second witness of that
# growth, reached 0.035 and 0.037. The kernel path's pooled gap is also
# held to BGE_WITNESS_X times the witness's
BGE_FREE_TOL, BGE_ROW_TOL, BGE_WITNESS_X = 0.06, 0.06, 2.0
# phase 23's padded decoder embedding: one position's unit vectors (0.019
# read on the same card)
EMBED23_ROW_TOL = 0.04
# kernel A's (K, N) on the BGE-M3 path: q / k / v / o, ffn_up, ffn_down
A_BGE_SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024)]
# CLIP ViT-L/14-336 (openai/clip-vit-large-patch14-336's vision_config) as
# LLaVA-1.6-Mistral-7B's mmproj keeps it: image 336, patch 14, hidden 1024,
# 16 heads, FF 4096, quickgelu, a class token and a pre-LN; the llava
# converter keeps 23 of its 24 layers (the penultimate layer's output) and
# no post-LN; the mlp projector 1024 -> 4096 -> 4096; CLIP's mean and std
CLIP_L336 = dict(IMAGE=336, PATCH=14, E=1024, L=23, H=16, FF=4096, PROJ=4096)
# whisper-large-v3's encoder as Qwen2-Audio-7B's audio tower
# (Qwen/Qwen2-Audio-7B's audio_config): 128 mel bins, hidden 1280, 32
# layers, 20 heads, FF 5120, 1,500 positions; after the avgpool of 2 the
# qwen2a projector 1280 -> 4096 with a bias (Qwen-7B's width, phase 4's)
WHISPER_L3 = dict(MEL=128, E=1280, L=32, H=20, FF=5120, POS=1500, PROJ=4096)
MM_GGUF_VERSION = "port-25"
MM_NEW = 32             # phase 25's greedy tokens after the splice
# phase 25's clip: one 3,000-frame chunk, 750 rows (the preprocessor pads
# 30 s of silence, so 30 s or more of audio makes a second chunk)
MM_AUDIO_S = 29.5
# the encoder on the card against the CPU, both float32 with no TF32, as a
# share of the largest |output|: the sums run in other orders
MM_ENC_TOL = 1e-3
# phase 17's ring-cache engine: the greedy tokens of each request
ENGINE17_NEW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- timing --
class Timer:
    """Median of CUDA-event times. Before each rep the L2 cache is flushed,
    so that weights are read from device memory as on the main path, and
    the card is kept busy for about half a millisecond while the host
    enqueues the timed call, so that host launch overhead stays out of a
    kernel's time (a plain version whose many launches outlast that still
    shows its host gaps). The flush writes a 128 MB buffer and then reads a
    second one, which leaves the L2 clean; ``dirty`` skips the read, so that
    the timed call first writes back the dirty lines the write left (up to
    the L2's 50 MB): the older flush, kept for ``flush_check``."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.checks = []        # (row, call, ms with dirty lines, ms with a clean L2)
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.sweep = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int | None = None, dirty: bool = False) -> float:
        torch = self.torch
        fn()                                    # warm (and first-launch) run
        ts = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            if not dirty:
                self.sweep.sum()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def host_us(self, fn, calls: int = 200, reps: int = 5) -> float:
        """Host µs a call of ``fn`` (median of ``reps``): ``calls`` calls
        enqueued behind a ~30-ms device sleep, so that the host clock sees
        their launch cost and no device time."""
        torch = self.torch
        per = []
        for _ in range(reps):
            torch.cuda._sleep(60_000_000)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(per)


def flush_check(timer, row: str, **calls) -> None:
    """Times each call of a kernel-table row after the write alone ("zero")
    and after the whole flush ("clean") and logs the two times: how much the
    dirty L2 lines left by the write inflate a small call."""
    parts = []
    for what, fn in calls.items():
        z, c = timer(fn, dirty=True), timer(fn)
        timer.checks.append((row, what, z, c))
        parts.append(f"{what} zero {z:.4f} clean {c:.4f} ms ({100 * (c / z - 1):+.1f}%)")
    log(f"    flush check, {row}: " + "; ".join(parts))


def flush_verdict(timer) -> None:
    if not timer.checks:
        return
    row, what, z, c = max(timer.checks, key=lambda r: abs(r[3] / r[2] - 1))
    log(f"[3] flush check: the largest move from the zero_() flush to the clean one is "
        f"{100 * (c / z - 1):+.1f}% ({row}, {what}: {z:.4f} -> {c:.4f} ms) over "
        f"{len(timer.checks)} calls; the table is timed under the clean flush")


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------- phases --
def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"[1] device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] plain versions in full float32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return {"name": name, "smi": line}


def phase_build(_cuda) -> None:
    t0 = time.perf_counter()
    built = _cuda.build(ptxas_verbose=True)
    log(f"[2] build: {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc, sm_90a)")
    for name, (_, text) in built.items():
        kernel = ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ""
            elif "registers" in ln or "spill" in ln.lower() and "0 bytes spill" not in ln:
                log(f"    {name} {demangled(kernel)}: {ln.strip()}")


def demangled(sym: str) -> str:
    """A kernel's name and template arguments from its mangled symbol
    (enough to tell the instantiations apart: e.g. qmatmul_i8_wgmma_kernel<128,6>)."""
    import re
    best = None
    for i in range(len(sym)):
        m = re.match(r"\d+", sym[i:])
        if m is None:
            continue
        n, start = int(m.group()), i + m.end()
        name = sym[start:start + n]
        if len(name) == n and name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            best = (name, start + n)
    if best is None:
        return sym[:60]
    name, end = best
    args = []
    if sym[end:end + 1] == "I":
        args = re.findall(r"Li(\d+)E", sym[end:sym.find("EE", end) + 2])
    return name + (f"<{','.join(args)}>" if args else "")


def sum_tol(k, absdot):
    """Two sums of the same exact bf16 products in float32, in different
    orders: 16 sqrt(K) float32 roundings of the largest sum of |x w|."""
    return 16 * k ** 0.5 * 2.0 ** -24 * absdot


def _record(results, kernel, case, err, tol, ms, plain_ms, lib_ms, bnd, note=""):
    ok = err <= tol
    log(f"    {kernel} {case}: max_abs_err {err:.3e} tol {tol:.3e} "
        f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'} "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}){note}")
    results.setdefault(kernel, []).append(dict(
        case=case, err=err, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1]))
    return ok


@contextmanager
def forced_splits(QM, splits: int, plan_name: str = "gemv_plan"):
    """The M <= 16 launches of kernel D (``gemv_plan``), kernel 15
    (``gemv4_plan``) or kernel A (``gemv_i8_plan``) with ``splits`` blocks
    a cluster."""
    plan = getattr(QM, plan_name)
    setattr(QM, plan_name, lambda *shape: dict(plan(*shape), splits=splits))
    try:
        yield
    finally:
        setattr(QM, plan_name, plan)


@contextmanager
def forced_width(QM, bn: int):
    """The M > 16 launches of kernel A with tiles of ``bn`` columns."""
    plan = QM.tiled_i8_plan

    def forced(m, n, k, sms=QM._cuda.DEFAULT_SMS):
        p = plan(m, n, k, sms)
        tiles = p["m_tiles"] * -(-n // bn)
        return dict(p, bn=bn, n_tiles=-(-n // bn), tiles=tiles, blocks=min(tiles, sms))
    QM.tiled_i8_plan = forced
    try:
        yield
    finally:
        QM.tiled_i8_plan = plan


@contextmanager
def forced_tm(QM, tm: int):
    """The M > 16 wgmma launches of kernels D and 15 with tiles of ``tm``
    tokens."""
    plan = QM.tiled_plan

    def forced(m, n, k, group, sms=QM._cuda.DEFAULT_SMS):
        p = plan(m, n, k, group, sms)
        if p["kernel"] != "wgmma":
            return p
        tiles = -(-m // tm) * p["n_tiles"]
        return dict(p, tm=tm, m_tiles=-(-m // tm), tiles=tiles, blocks=min(tiles, sms))
    QM.tiled_plan = forced
    try:
        yield
    finally:
        QM.tiled_plan = plan


def tm_sweep(timer, QM, sms: int, what: str, m: int, n: int, k: int, fn) -> None:
    """ms a call of a wgmma kernel by the tokens of its tiles (* =
    tiled_plan's choice)."""
    want = QM.tiled_plan(m, n, k, 32, sms)["tm"]
    row = []
    for tm in QM.TILED_TILE_COST:
        with forced_tm(QM, tm):
            t = timer(fn, 5)
        row.append(f"{tm}{'*' if tm == want else ''} {t:.4f} "
                   f"({-(-m // tm) * -(-n // QM.TILED_TN)} tiles)")
    log(f"    {what} M={m} K={k} N={n}: ms by tokens a tile: " + ", ".join(row))


def dq_record(QM, sms: int, kernel: str, m: int, n: int, k: int, group: int, gemv_note: str):
    """The kernel-table row and launch note of a kernel D or 15 call: the
    wgmma form's own row at M > 16 where tiled_plan takes the shape."""
    if m <= QM.GEMV_MAX_M:
        return kernel, gemv_note
    plan = QM.tiled_plan(m, n, k, group, sms)
    if plan["kernel"] != "wgmma":
        return kernel, " | the mma.sync tiled kernel (tiled_plan)"
    return f"{kernel}_wgmma", (f" | wgmma plan: {plan['tn']}x{plan['tm']} tiles (columns x "
                               f"tokens), {plan['tiles']} tiles on {plan['blocks']} blocks")


@contextmanager
def forced_cols(MD, cols: int):
    """The launches of kernels 8 and 13 with ``cols`` columns a block
    (``down_plan`` then picks the lanes a row for that)."""
    plan = MD.down_plan
    MD.down_plan = lambda *shape: plan(*shape, cols=cols)
    try:
        yield
    finally:
        MD.down_plan = plan


@contextmanager
def forced_gate_up_cols(MD, cols: int):
    """The launches of kernels 12 (``gate_up_plan``) and 7
    (``gate_up_i8_plan``) with ``cols`` columns a block (the plan then
    picks the lanes a row for that)."""
    plans = MD.gate_up_plan, MD.gate_up_i8_plan
    MD.gate_up_plan = lambda *shape: plans[0](*shape, cols=cols)
    MD.gate_up_i8_plan = lambda *shape: plans[1](*shape, cols=cols)
    try:
        yield
    finally:
        MD.gate_up_plan, MD.gate_up_i8_plan = plans


def gate_up_sweep(timer, MD, plan, what: str, p: int, k: int, ff: int, fn) -> None:
    """ms a call of kernel 7 or 12 (``fn``) by the columns a block and the
    lanes a row its ``plan`` gives them (* = the plan's own)."""
    want = plan(p, k, ff)["cols"]
    row = []
    for cols in (2, 4, 8, 16, 32):
        lanes = plan(p, k, ff, cols=cols)["lanes"]
        with forced_gate_up_cols(MD, cols):
            row.append(f"{cols}x{lanes}{'*' if cols == want else ''} {timer(fn, 5):.4f}")
    log(f"    {what}: ms by columns a block x lanes a row: " + ", ".join(row))


@contextmanager
def forced_heads(FA, n: int):
    """The launches of kernel 6 with blocks of ``n`` query heads of a GQA
    group (where ``prefill_q8_heads`` allows n; else 1)."""
    old = FA.Q8_HEADS
    FA.Q8_HEADS = n
    try:
        yield
    finally:
        FA.Q8_HEADS = old


def tiled_text(plan: dict) -> str:
    return (f"plan: {plan['bm']}x{plan['bn']} tiles, {plan['tiles']} tiles on "
            f"{plan['blocks']} blocks")


def plan_text(plan: dict) -> str:
    return (f"plan: {plan['cols']} columns a block, {plan['lanes']} lanes a row, "
            f"{plan['blocks']} blocks, {plan['chunks']} chunks a lane, "
            f"{plan['passes']} pass(es)")


def cols_sweep(timer, MD, what: str, t, top_k, f, e, group, fn) -> None:
    """ms a call of a down kernel by the columns a block (* = down_plan's)."""
    want = MD.down_plan(t, top_k, f, e, group)["cols"]
    row = []
    for cols in (2, 4, 8, 16, 32):
        with forced_cols(MD, cols):
            row.append(f"{cols}{'*' if cols == want else ''} {timer(fn, 5):.4f}")
    log(f"    {what}: ms by columns a block: " + ", ".join(row))


def grouped_library(x, w_bf16, group_sizes):
    """The library yardstick of kernels 10 and 14: one bf16 grouped product
    (``torch._grouped_mm``) of x's rows, sorted by group, against their
    groups' dequantized weights ``w_bf16`` (G, K, N), in group order; the
    output is bf16 and rows past sum(group_sizes) are left undefined. The
    port never calls it."""
    import torch
    offs = torch.cumsum(group_sizes.to(torch.int64), 0).to(torch.int32)
    return torch._grouped_mm(x, w_bf16, offs=offs)


def k_major(w):
    """(G, K, N) -> the same values as the (G, K, N) view of a contiguous
    (G, N, K) tensor: the layout the card's grouped product reads."""
    return w.transpose(1, 2).contiguous().transpose(1, 2)


def time_grouped(timer, x, w_bf16, gs, what: str):
    """``grouped_library``'s time, or None (logged with the reason) where
    the card's build refuses the shape."""
    try:
        return timer(lambda: grouped_library(x, w_bf16, gs))
    except RuntimeError as e:
        log(f"    library n/a for {what}: torch._grouped_mm refused it: "
            f"{str(e).splitlines()[0][:160]}")
        return None


def phase_kernels(torch, timer, results) -> bool:
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    shapes = [(E, (H + 2 * HKV) * D), (E, E), (E, 2 * FF), (FF, E), (E, V)]

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("[3] kernel A (qmatmul_i8) vs plain; library = dense bf16 torch.matmul "
        "at the same (M, K, N), a yardstick, not the same function. M <= 16 runs "
        "qmatmul_i8_gemv_kernel (K split over a cluster of `splits` blocks), M > 16 the "
        "tiled qmatmul_i8_wgmma_kernel (persistent grid, tiled_i8_plan); bound = the "
        "larger of the bytes read once (x, scales, codes, out) and the int8 operations")
    from ik_llama_cpp_tpu_torch.ops import _cuda
    log("[3] tiled A's warpgroup MMAs in SASS: " + sass_opcodes(
        _cuda._lib_path("qmatmul_i8"), "qmatmul_i8_wgmma_kernel", "IGMMA"))
    # the dense decode linears and head at M 1, 8, 16 and the prefill chunk;
    # then at M = 1 the attention linears and heads of the two MoE models
    a_cases = [(k, n, (1, 8, 16, 512)) for k, n in shapes]
    a_cases += [(k, n, (1, 512)) for k, n in A_MOE_SHAPES + A_GEMMA_SHAPES]
    a_cases += [(k, n, (1, 512)) for k, n in A_QNEXT_SHAPES if (k, n) not in A_MOE_SHAPES]
    # rows 1s: phase 20's verify blocks at every dense linear, one row of
    # W = 5 or 9 (the GEMV) and the engine's 4 rows of 9 (the tiled form)
    a_cases += [(k, n, (5, 9, 36)) for k, n in shapes]
    # rows 1a: GLM-4.5-Air's linears (phase 21; eh_proj is row 1m) at the
    # decode and MTP draft step, the verify chunks and MTP refresh padded to
    # 8 and 16 rows, and the prefill chunk
    a_cases += [(k, n, (1,) + GLM_VERIFY_ROWS + (512,)) for k, n in A_GLM_SHAPES]
    # rows 1b: Mamba-2.8B's ssm_in, ssm_out and tied head (phase 22) at the
    # decode step and the prefill chunk
    a_cases += [(k, n, (1, 512)) for k, n in A_MAMBA_SHAPES]
    # rows 1e: BGE-M3's linears (phase 24) at a 512- and an 8,192-token document
    a_cases += [(k, n, (512, 8192)) for k, n in A_BGE_SHAPES]
    for k, n, ms in a_cases:
        if (k, n) == A_MAMBA_SHAPES[0]:
            log("[3] rows 1b: kernel A at Mamba-2.8B's ssm_in, ssm_out and tied head")
        if (k, n) == A_BGE_SHAPES[0]:
            log("[3] rows 1e: kernel A at BGE-M3's q/k/v/o, ffn_up and ffn_down (a forward "
                "launches 96, 24 and 24 of them)")
        codes_t = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                                dtype=torch.int8)
        sw = torch.rand((k // 256, n), generator=gen, device="cuda") * 1e-3
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda")
            xq, xs = QM.quantize_activations(x)
            got = QM.qmatmul_i8(xq, xs, codes_t.t(), sw)
            ref = QM.qmatmul_i8_ref(xq, xs, codes_t.t(), sw)
            again = bool(torch.equal(got, QM.qmatmul_i8(xq, xs, codes_t.t(), sw)))
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max()) + 1e-6
            xb = x.to(torch.bfloat16)
            nsg = k // 256
            bnd = bound_ms(m * k + m * nsg * 4 + k * n + nsg * n * 4 + m * n * 4,
                           2.0 * m * n * k, INT8_OPS)
            note = (f" | gemv splits {QM.gemv_i8_plan(m, n, k)['splits']}" if m <= 16
                    else " | tiled " + tiled_text(QM.tiled_i8_plan(m, n, k, sms))) + \
                f"; repeats bit for bit: {again}"
            if m == 1:      # decode's launch cost, on which every decode path waits
                t0 = time.perf_counter()
                for _ in range(10000):
                    QM.gemv_i8_plan(m, n, k)
                plan_us = (time.perf_counter() - t0) / 10000 * 1e6
                call_us = timer.host_us(lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw))
                note += f"; host {call_us:.1f} us a call, of which gemv_i8_plan {plan_us:.2f}"
            if (k, n) in shapes and m in (5, 9, 36):
                # rows 1s: the int8 library product beside the bf16 one
                # (torch._int_mm: int8 x int8 -> int32, no scales; it takes M > 16)
                note += "; torch._int_mm " + (
                    f"{timer(lambda: torch._int_mm(xq, codes_t.t())):.4f} ms" if m > 16
                    else "n/a (M <= 16)")
            ok &= again
            ok &= _record(results, "qmatmul_i8", f"M={m} K={k} N={n}", err, tol,
                          timer(lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw)),
                          timer(lambda: QM.qmatmul_i8_ref(xq, xs, codes_t.t(), sw), 3),
                          timer(lambda: torch.matmul(xb, wb)), bnd, note=note)
            if (m, k, n) == (1, E, 2 * FF):
                flush_check(timer, f"A M={m} K={k} N={n}",
                            kernel=lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw),
                            library=lambda: torch.matmul(xb, wb))
        del codes_t, wb

    log("[3] kernel A's K split against its time at M <= 16 (ms a call by the number "
        "of blocks in a cluster; * = gemv_i8_plan's choice)")
    # where the plan splits (few column tiles) and where it stops (896 tiles)
    for m, k, n in ((1, 2048, 2048), (1, 2048, 6144), (1, E, E), (16, E, E), (1, FF, E),
                    (1, E, 2 * FF)):
        codes_t = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                                dtype=torch.int8)
        sw = torch.rand((k // 256, n), generator=gen, device="cuda") * 1e-3
        xq, xs = QM.quantize_activations(torch.randn((m, k), generator=gen, device="cuda"))
        plan = QM.gemv_i8_plan(m, n, k)["splits"]
        row = []
        for sp in range(1, QM.GEMV_MAX_SPLITS + 1):
            with forced_splits(QM, sp, "gemv_i8_plan"):
                row.append(f"{sp}{'*' if sp == plan else ''} "
                           f"{timer(lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw), 5):.4f}")
        log(f"    M={m} K={k} N={n}: " + ", ".join(row))
        del codes_t

    log("[3] tiled A's tile width against its time at M = 512 (ms a call by the columns "
        "of a tile; * = tiled_i8_plan's choice; bf16 torch.matmul beside)")
    for k, n in shapes + A_MOE_SHAPES:
        m = 512
        codes_t = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                                dtype=torch.int8)
        sw = torch.rand((k // 256, n), generator=gen, device="cuda") * 1e-3
        xq, xs = QM.quantize_activations(torch.randn((m, k), generator=gen, device="cuda"))
        plan = QM.tiled_i8_plan(m, n, k, sms)
        row = []
        for bn in (64, 128, 192):
            with forced_width(QM, bn):
                t = timer(lambda: QM.qmatmul_i8(xq, xs, codes_t.t(), sw), 5)
            tiles = QM.tiled_i8_plan(m, n, k, sms)["m_tiles"] * -(-n // bn)
            row.append(f"{bn}{'*' if bn == plan['bn'] else ''} {t:.4f} ({tiles} tiles)")
        log(f"    M={m} K={k} N={n}: " + ", ".join(row))
        del codes_t

    log("[3] kernel D (qmatmul, planar group 32) vs plain; library as for A. M <= 16 "
        "runs qmatmul_gemv_kernel (K split over a cluster of `splits` blocks), M > 16 "
        "qmatmul_wgmma_kernel (persistent grid, tiled_plan; row qmatmul_wgmma); bound = the "
        "larger of the bytes read once (codes, scales, x, out) and the bf16 operations")
    log("[3] tiled D's warpgroup MMAs in SASS: " + sass_opcodes(
        _cuda._lib_path("qmatmul"), "qmatmul_wgmma_kernel", "HGMMA"))
    # the planar dense shapes (fused qkv, wo, fused gate/up, down, the head),
    # K % 256 != 0 (Qwen1.5-MoE-A2.7B's 1408), a partial column tile (4000)
    # and rows that are not 16-byte aligned (1000)
    d_cases = [(k, n, (1, 4, 16, 17, 64, 512), torch.bfloat16, i == 0)
               for i, (k, n) in enumerate(shapes)]
    d_cases += [(E, 2 * FF, (1, 16), torch.float32, False),
                (1408, 2048, (1, 4, 16), torch.bfloat16, False),
                (E, 4000, (1, 16), torch.bfloat16, False),
                (1408, 1000, (1, 16), torch.float32, True)]
    # rows 4a: GLM-4.5-Air's planar downs (phase 21), the dense layer's K
    # 10944 and the shared expert's K 1408, to N 4096, at the decode step,
    # the verify chunks and the prefill chunk
    d_cases += [(k, GLM_AIR["E"], (1,) + GLM_VERIFY_ROWS + (512,), torch.bfloat16, False)
                for k in (GLM_AIR["FFD"], GLM_AIR["FFS"])]
    for k, n, ms, sdt, with_bias in d_cases:
        codes = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scale = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(sdt)
        bias = None
        if with_bias:
            bias = (torch.randn((k // 32, n), generator=gen, device="cuda") * 0.01).to(sdt)
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
        absw = QM._dequant_bf16(codes, scale, bias, 32).float().abs()
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            got = QM.qmatmul(x, codes, scale, bias)
            ref = QM.qmatmul_ref(x, codes, scale, bias)
            again = QM.qmatmul(x, codes, scale, bias)
            absdot = float((x.float().abs() @ absw).max())
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = sum_tol(k, absdot)
            sb = scale.element_size() * (2 if bias is not None else 1)
            bnd = bound_ms(m * k * 2 + k * n + sb * (k // 32) * n + m * n * 4,
                           2.0 * m * n * k, BF16_FLOPS)
            name, note = dq_record(QM, sms, "qmatmul", m, n, k, 32,
                                   f" | gemv splits {QM.gemv_plan(m, n, k, 32)['splits']}"
                                   if m <= 16 else "")
            note += f"; repeats bit for bit: {bool(torch.equal(got, again))}"
            ok &= bool(torch.equal(got, again))
            ok &= _record(results, name, f"M={m} K={k} N={n}"
                          + (" bias" if bias is not None else "")
                          + (" f32 scales" if sdt == torch.float32 else ""), err, tol,
                          timer(lambda: QM.qmatmul(x, codes, scale, bias)),
                          timer(lambda: QM.qmatmul_ref(x, codes, scale, bias), 3),
                          timer(lambda: torch.matmul(x, wb)), bnd, note=note)
        del codes, wb, absw

    log("[3] tiled D's tile width against its time at M = 512 (ms a call by the tokens of a "
        "tile; * = tiled_plan's choice)")
    for k, n in shapes:
        codes = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scale = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        x = torch.randn((512, k), generator=gen, device="cuda").to(torch.bfloat16)
        tm_sweep(timer, QM, sms, "D", 512, n, k, lambda: QM.qmatmul(x, codes, scale))
        del codes

    log("[3] kernel D's K split against its time at M <= 16 (ms a call by the number "
        "of blocks in a cluster; * = gemv_plan's choice)")
    for m, k, n in ((1, E, 2 * FF), (16, E, 2 * FF), (1, E, 6144), (16, E, 6144), (1, E, E),
                    (16, E, E), (1, FF, E), (16, FF, E), (16, E, FF)):
        codes = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scale = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        plan = QM.gemv_plan(m, n, k, 32)["splits"]
        row = []
        for sp in range(1, QM.GEMV_MAX_SPLITS + 1):
            with forced_splits(QM, sp):
                row.append(f"{sp}{'*' if sp == plan else ''} "
                           f"{timer(lambda: QM.qmatmul(x, codes, scale), 5):.4f}")
        log(f"    M={m} K={k} N={n}: " + ", ".join(row))
        del codes

    def attn_case(kernel, fn, b, t, s, qpos, kvlen, H=H, HKV=HKV, d=D, window=0,
                  softcap=0.0):
        scale_ = 1.0 / float(np.sqrt(d))
        kw = dict(scale=scale_, swa_window=window, softcap=softcap)
        q = torch.randn((b, t, H, d), generator=gen, device="cuda").to(torch.bfloat16)
        kc = torch.randn((b, s, HKV, d), generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn((b, s, HKV, d), generator=gen, device="cuda").to(torch.bfloat16)
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        got = fn(q, kc, vc, qp, kl, **kw)
        ref = FA.attention_ref(q, kc, vc, qp, kl, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        # p is rounded to bf16 before the PV product and the output is bf16:
        # two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        # library: SDPA on the live rows with an explicit mask, the window
        # in it but no softcap, which SDPA has not (not timed: the mask, the
        # GQA repeat)
        pos = torch.arange(s, device="cuda")
        qpos_t = qp[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos_t[:, :, None]) & \
            (pos[None, None, :] < kl[:, None, None])
        if window:
            mask &= pos[None, None, :] > qpos_t[:, :, None] - window
        kr = kc.repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        vr = vc.repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        qt = q.transpose(1, 2)
        m4 = mask[:, None]
        lib = timer(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4,
                                                           scale=scale_))
        live = int(mask.sum())               # (query, key) pairs this run needs
        keys = int(mask.any(dim=1).sum())    # keys at least one query reads
        bnd = bound_ms(2 * (b * t * H * d * 2) + 2 * keys * HKV * d * 2,
                       4.0 * H * d * live, BF16_FLOPS)
        case = (f"B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen}"
                + ("" if (H, HKV) == (32, 8) else f" H={H} HKV={HKV}")
                + ("" if d == D else f" D={d}") + (f" window={window}" if window else "")
                + (f" softcap={softcap:g}" if softcap else ""))
        note = ""
        if fn is FA.flash_attention_decode:
            again = bool(torch.equal(got, fn(q, kc, vc, qp, kl, **kw)))
            plan = FA.decode_split_plan(b, t, H, HKV, s, d, d, sms)
            blocks = [len(FA.decode_key_ranges(plan, max(0, qpos[i] + 1 - window)
                                               if window else 0,
                                               min(kvlen[i], qpos[i] + t)))
                      for i in range(b)]
            note = (f" | plan: {plan['splits']} splits x {plan['groups']} groups, "
                    f"round {plan['round']} keys, blocks working a group {blocks}; "
                    f"repeats bit for bit: {again}")
            if not again:
                err = float("inf")
        return _record(results, kernel, case, err, tol,
                       timer(lambda: fn(q, kc, vc, qp, kl, **kw)),
                       timer(lambda: FA.attention_ref(q, kc, vc, qp, kl, **kw), 3),
                       lib, bnd, note=note)

    log("[3] kernel B (flash_attention, prefill) vs plain; library = SDPA")
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [0], [512])
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [256], [768])
    # row 2L: the last chunk of phase 9's long fill over the bf16 cache
    # (beside kernel 6's row 6L over the q8 one)
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 4096, [3488], [4000])
    # the head layouts of Qwen3-30B-A3B (32 / 4) and Qwen1.5-MoE-A2.7B (16 / 16)
    for hq, hkv in ((MOE["H"], MOE["HKV"]), (Q2MOE["H"], Q2MOE["HKV"])):
        ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [0], [512],
                        H=hq, HKV=hkv)
    log("[3] kernel C (flash_attention_decode, split-K fa_decode_kernel) vs plain; "
        "library = SDPA")
    for t in (1, 8):
        for s, kvls in ((1024, (1, 513)), (4096, (1, 513, 4000))):
            for kvl in kvls:
                ok &= attn_case("flash_attention_decode", FA.flash_attention_decode,
                                1, t, s, [max(kvl - t, 0)], [kvl])
        ok &= attn_case("flash_attention_decode", FA.flash_attention_decode,
                        2, t, 1024, [513 - t, 1000 - t], [513, 1000])
    # no grouped queries (Qwen1.5-MoE-A2.7B): one query row per KV head
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, 1, 1024,
                    [512], [513], H=Q2MOE["H"], HKV=Q2MOE["HKV"])
    # the gemma sliding-window layers (phase 17): head dim 256, window 1,024
    # and Gemma-2's softcap of 50 at 4,000 keys; B at the long fill's last
    # chunk, C at the decode step after it
    g = dict(H=GEMMA3["H"], HKV=GEMMA3["HKV"], d=GEMMA3["D"], window=GEMMA3["WINDOW"],
             softcap=50.0)
    log("[3] kernels B and C at head dim 256 with a 1,024-key window and softcap 50 "
        "(gemma's sliding-window layers); library = SDPA with the window, no softcap")
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 4096, [3488], [4000], **g)
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, 1, 4096,
                    [3999], [4000], **g)
    # Qwen3-Next-80B-A3B's attention layers (phase 19): 16 gated q heads over
    # 2 kv heads of 256, a GQA ratio of 8; row 2q, the second chunk of the
    # 1,024-token prefill, and row 3q, the decode step over its 1,024 keys
    qn = dict(H=QNEXT["H"], HKV=QNEXT["HKV"], d=QNEXT["D"])
    log("[3] kernels B and C at 16 query heads over 2 kv heads of 256 (Qwen3-Next's "
        "attention layers); library = SDPA")
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 1024, [512], [1024], **qn)
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, 1, 1024,
                    [1023], [1024], **qn)
    # rows 3s: the speculative verify blocks at the shapes phases 19-21 give
    # kernel C: phase 20's W = 5 and 9 over the dense model's 32 / 8 heads
    # (at 4,000 cached keys, and the engine's 4 rows of 9 at its own
    # positions); phase 21's decode and MTP draft step (T = 1) and its verify
    # chunks and MTP refresh padded to 8 and 16 rows over GLM-4.5-Air's
    # 96 / 8 heads (at 4,000 keys and at the phase's own ~560); phase 19's
    # rollback verify, padded to 8 rows over Qwen3-Next's 16 / 2 of 256.
    # Row 2a: kernel B at GLM-4.5-Air's heads, the phase's 512-token prefill
    # and the MTP layer's warm-up over it
    log("[3] kernels B and C at the speculative verify blocks of phases 19-21 (rows 3s, "
        "2a); library = SDPA")
    for t in (5, 9):
        ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, t, 4096,
                        [4000 - t], [4000])
    kvls = [256 + 9, 280 + 9, 300 + 9, 320 + 9]
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 4, 9, 1280,
                    [k - 9 for k in kvls], kvls)
    glm = dict(H=GLM_AIR["H"], HKV=GLM_AIR["HKV"])
    for t in (1,) + GLM_VERIFY_ROWS:
        ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, t, 4096,
                        [4000 - t], [4000], **glm)
        ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, t, 768,
                        [560 - t], [560], **glm)
    ok &= attn_case("flash_attention", FA.flash_attention, 1, 512, 768, [0], [512], **glm)
    ok &= attn_case("flash_attention_decode", FA.flash_attention_decode, 1, 8, 512,
                    [260], [268], **qn)

    # DeepSeek-V2-Lite's attention (phase 18): rows 2m (the last chunk of a
    # 3,999-token fill: the wgmma form) and 2md / 2md2 (the decode step after
    # it, one and two slots: the decode form) of the MLA form, 16 heads over
    # the one latent head, v the first 512 columns of k; rows 2m128 / 2md128
    # the same at DeepSeek-V3's 128 heads (random tensors, no model); row
    # 2k, kernel B at the mla=False path's 16 / 16 heads of 192 / 128
    ds = dict(hkv=1, dk=DSV2["LORA_KV"] + DSV2["ROPE"], dv=DSV2["LORA_KV"])
    log("[3] the MLA form of kernel B (flash_attention_mla: DeepSeek-V2-Lite's and "
        "DeepSeek-V3's heads over the latent cache) and B at its mla=False heads; "
        "library = SDPA with enable_gqa")
    for h in (DSV2["H"], DSV3_H):
        ok &= mla_case(torch, timer, results, gen, "flash_attention_mla", 1, 512, 4096, [3488],
                       [4000], h=h, **ds)
        ok &= mla_case(torch, timer, results, gen, "flash_attention_mla", 1, 1, 4096, [3999],
                       [4000], h=h, **ds)
    ok &= mla_case(torch, timer, results, gen, "flash_attention_mla", 2, 1, 4096, [1500, 3999],
                   [1501, 4000], h=DSV2["H"], **ds)
    ok &= mla_case(torch, timer, results, gen, "flash_attention", 1, 512, 4096, [3488], [4000],
                   h=DSV2["H"], hkv=DSV2["H"], dk=DSV2["NOPE"] + DSV2["ROPE"], dv=DSV2["DV"])
    mla_sweep(torch, timer, gen, ds, sms)
    return ok


def mla_sweep(torch, timer, gen, ds: dict, sms: int) -> None:
    """Rows 2md, 2md2 and 2md128 (T = 1 at 4,000 keys) by the decode
    form's key splits: ms a call by blocks a row tile (* = mla_plan's
    choice; a split call is a cooperative launch, so groups x splits stays
    within the SMs). Row 2m takes one split: its 128 row tiles fill the
    card."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    for what, b, t, h, qpos, kvlen, points in (
            ("2md", 1, 1, DSV2["H"], [3999], [4000], (1, 8, 16, 32, 64, 96, 128)),
            ("2md2", 2, 1, DSV2["H"], [1500, 3999], [1501, 4000], (1, 8, 16, 32, 48, 64)),
            ("2md128", 1, 1, DSV3_H, [3999], [4000], (1, 4, 8, 12, 16))):
        q = torch.randn((b, t, h, ds["dk"]), generator=gen, device="cuda").to(torch.bfloat16)
        kc = torch.randn((b, 4096, 1, ds["dk"]), generator=gen, device="cuda").to(torch.bfloat16)
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        plan = FA.mla_plan(b, t, h, 4096, sms)
        row = []
        for sp in points:
            if sp > 1 and plan["groups"] * sp > sms:
                continue
            with forced_mla_plan(FA, splits=sp):
                ms = timer(lambda: FA.flash_attention(q, kc, kc[..., :ds["dv"]], qp, kl,
                                                      scale=0.07), 5)
            row.append(f"{sp}{'*' if sp == plan['splits'] else ''} {ms:.4f}")
        log(f"[3] {what}: the {plan['form']} form by key splits ({plan['tiles']} row tiles of "
            f"{plan['rows']} a batch row, B={b}; ms a call): " + ", ".join(row))


@contextmanager
def forced_mla_plan(FA, **knobs):
    """The MLA form's launches with the plan's knobs (``splits``) forced."""
    saved = FA.mla_plan
    FA.mla_plan = lambda *a, **kw: dict(saved(*a, **kw), **knobs)
    try:
        yield
    finally:
        FA.mla_plan = saved


def sdpa_library(torch, timer, q, k, v, mask, scale: float):
    """One SDPA call of the same function (the kv heads shared by
    enable_gqa, the causal / fill mask explicit): the time of the first
    backend of cuDNN, memory-efficient and math that takes the shapes
    (Dk != Dv and a head dim of 576 rule some out), and its name."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt, m4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4, scale=scale,
                                                      enable_gqa=True)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:            # the backend refuses these shapes: the next one
            continue
        return timer(call), be.name
    return None, "none"


def mla_case(torch, timer, results, gen, kernel, b, t, s, qpos, kvlen, *, h, hkv, dk, dv):
    """``flash_attention`` at a DeepSeek-2 family's heads against its plain
    version: the MLA form (hkv 1, v a view of k's first dv columns) or
    kernel B (hkv = h); with the library call, the bound and (MLA form)
    its plan and a bit-for-bit repeat."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    scale_ = 1.0 / float(np.sqrt(DSV2["NOPE"] + DSV2["ROPE"]))
    q = torch.randn((b, t, h, dk), generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn((b, s, hkv, dk), generator=gen, device="cuda").to(torch.bfloat16)
    vc = (kc[..., :dv] if hkv == 1 else
          torch.randn((b, s, hkv, dv), generator=gen, device="cuda").to(torch.bfloat16))
    qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
    fn = lambda: FA.flash_attention(q, kc, vc, qp, kl, scale=scale_)
    ref_fn = lambda: FA.attention_ref(q, kc, vc, qp, kl, scale=scale_)
    got, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = 2.0 ** -7 * float(ref.float().abs().max())    # p in bf16 before PV: two ulps
    pos = torch.arange(s, device="cuda")
    qpos_t = qp[:, None] + torch.arange(t, device="cuda")[None, :]
    mask = (pos[None, None, :] <= qpos_t[:, :, None]) & (pos[None, None, :] < kl[:, None, None])
    lib, backend = sdpa_library(torch, timer, q, kc, vc, mask, scale_)
    live = int(mask.sum()) * h               # (query row, key) pairs this run needs
    keys = int(mask.any(dim=1).sum())        # keys at least one query reads
    kv_bytes = keys * hkv * (dk if hkv == 1 else dk + dv) * 2   # v is inside k's rows
    bnd = bound_ms(b * t * h * (dk + dv) * 2 + kv_bytes, 2.0 * live * (dk + dv), BF16_FLOPS)
    case = f"B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen} H={h} HKV={hkv} Dk={dk} Dv={dv}"
    note = f" | library backend {backend}"
    if kernel == "flash_attention_mla":
        again = bool(torch.equal(got, fn()))
        plan = FA.mla_plan(b, t, h, s, _sms(torch))
        note += (f"; plan: {plan['form']} form, {plan['tiles']} row tiles of {plan['rows']} "
                 f"x {plan['splits']} splits, cluster {plan['cluster']}; repeats bit for bit: "
                 f"{again}")
        if not again:
            err = float("inf")
    return _record(results, kernel, case, err, tol, timer(fn), timer(ref_fn, 3), lib, bnd,
                   note=note)


def _sms(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_moe_kernels(torch, timer, results, c=MOE, dev="cuda") -> bool:
    """Kernels 7-10 against their plain versions at the MoE path's shapes
    (128 experts, E 2048, FF 768). Library yardsticks are bf16 torch.bmm
    calls over the same rows and gathered expert weights (7-9: a comparable,
    heavier function, not the same one) and, for 10, one bf16 grouped
    product over the same rows, group sizes and dequantized experts."""
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    g_, e_, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)

    def codes(n, k):          # (G, K, N) view of a contiguous (G, N, K) tensor
        return torch.randint(-127, 128, (g_, n, k), generator=gen, device=dev,
                             dtype=torch.int8).transpose(1, 2)

    def scales(k, n):
        return torch.rand((g_, k // 256, n), generator=gen, device=dev) * 2e-3 + 1e-5

    gate, up, down = codes(ff, e_), codes(ff, e_), codes(e_, ff)
    gsw, usw, dsw = scales(e_, ff), scales(e_, ff), scales(ff, e_)
    nsg, nsgf = e_ // 256, ff // 256
    ok = True

    log("[3] kernels 7/8 (moe_decode_gate_up_i8 / moe_decode_down_i8) vs plain; "
        "library = bf16 torch.bmm over the gathered pairs' gate|up / down")
    for t in (1, 8):
        p = t * topk
        ids = torch.from_numpy(np.concatenate([rng.permutation(g_)[:topk] for _ in range(t)])
                               .astype(np.int32)).to(dev)
        nd = len(set(ids.tolist()))               # distinct experts this run reads
        x = torch.randn((p, e_), generator=gen, device=dev)
        xq, xs = quantize_activations(x)
        a7 = (xq, xs.t(), ids, gate, gsw, up, usw)
        got, ref = MD.moe_decode_gate_up_i8(*a7), MD.moe_decode_gate_up_i8_ref(*a7)
        rep = bool(torch.equal(got, MD.moe_decode_gate_up_i8(*a7)))
        sync(torch)
        ok &= rep
        err = float((got.float() - ref.float()).abs().max())
        # h is bf16: two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        bnd = bound_ms(p * e_ + p * nsg * 4 + p * 4 + nd * (2 * e_ * ff + 2 * nsg * ff * 4)
                       + p * ff * 2, 4.0 * p * e_ * ff, INT8_OPS)
        li = ids.long()
        wb = torch.cat([gate[li], up[li]], dim=2).to(bf16)
        xb = x.to(bf16)[:, None, :]
        ok &= _record(results, "moe_decode_gate_up_i8", f"P={p} K={e_} FF={ff} G={g_}",
                      err, tol, timer(lambda: MD.moe_decode_gate_up_i8(*a7)),
                      timer(lambda: MD.moe_decode_gate_up_i8_ref(*a7), 3),
                      timer(lambda: torch.bmm(xb, wb)), bnd,
                      note=f" | {plan_text(MD.gate_up_i8_plan(p, e_, ff))}; bit-identical to "
                           f"plain: {bool(torch.equal(got, ref))}; repeats bit for bit: {rep}")
        gate_up_sweep(timer, MD, MD.gate_up_i8_plan, f"kernel 7 P={p}", p, e_, ff,
                      lambda: MD.moe_decode_gate_up_i8(*a7))
        del wb
        hq, hs = quantize_activations(ref)
        a8 = (hq, hs.t(), ids, down, dsw)
        got = MD.moe_decode_down_i8(*a8, top_k=topk)
        ref = MD.moe_decode_down_i8_ref(*a8, top_k=topk)
        again = MD.moe_decode_down_i8(*a8, top_k=topk)
        sync(torch)
        err = float((got - ref).abs().max())
        # exact integer dots, corrections added in the same order and
        # rounded at the same steps: the kernel must give the plain version's
        # bits; the tolerance is the float32 reassociation bound kept from
        # before the redesign
        tol = 1e-5 * float(ref.abs().max()) + 1e-6
        same, rep = bool(torch.equal(got, ref)), bool(torch.equal(got, again))
        ok &= same and rep
        bnd = bound_ms(p * ff + p * nsgf * 4 + p * 4 + nd * (ff * e_ + nsgf * e_ * 4)
                       + t * e_ * 4, 2.0 * p * ff * e_, INT8_OPS)
        wb = down[li].to(bf16)
        hb = hq.to(bf16)[:, None, :]
        ok &= _record(results, "moe_decode_down_i8", f"P={p} FF={ff} E={e_} G={g_}",
                      err, tol, timer(lambda: MD.moe_decode_down_i8(*a8, top_k=topk)),
                      timer(lambda: MD.moe_decode_down_i8_ref(*a8, top_k=topk), 3),
                      timer(lambda: torch.bmm(hb, wb)), bnd,
                      note=f" | {plan_text(MD.down_plan(t, topk, ff, e_))}; "
                           f"bit-identical to plain: {same}; repeats bit for bit: {rep}")
        cols_sweep(timer, MD, f"kernel 8 P={p}", t, topk, ff, e_, None,
                   lambda: MD.moe_decode_down_i8(*a8, top_k=topk))
        if t == 1:
            flush_check(timer, f"8 P={p} FF={ff} E={e_}",
                        kernel=lambda: MD.moe_decode_down_i8(*a8, top_k=topk),
                        library=lambda: torch.bmm(hb, wb))
        del wb

    r = 40
    log("[3] kernel 9 (fused_moe_prefill_i8) vs plain; library = bf16 torch.bmm of "
        "the live buckets against their gate|up")
    for n_live in (g_, min(37, g_ // 2)):
        sizes = np.zeros(g_, np.int64)
        sizes[rng.permutation(g_)[:n_live]] = rng.integers(1, r + 1, n_live)
        xg, xst, eids, nl, _ = fused_buckets(torch, sizes, g_, r, e_, gen, dev)
        ok &= prefill_case(torch, timer, results,
                           (xg, xst, eids, nl, gate, gsw, up, usw, down, dsw), n_live, r, c,
                           f"G={g_} R={r} K={e_} FF={ff} E={e_} n_live={n_live}")
        del xg

    m = PREFILL * topk                          # the rows of a 512-token chunk
    log("[3] kernel 10 (ragged_qmatmul_i8, ragged_i8_wgmma_kernel) vs plain: the plain "
        "version's bits and a repeat; library = bf16 grouped product over the live experts "
        "(torch._grouped_mm of the dequantized rows and experts)")
    skew = rng.multinomial(m, (1.0 / np.arange(1, g_ + 1)) / np.sum(1.0 / np.arange(1, g_ + 1)))
    size_sets = {"skewed": rng.permutation(skew), "zero": np.zeros(g_, np.int64),
                 "mid-tile": np.full(g_, m // g_)}    # 32-row groups: every other start is mid-tile
    for k, n, w, sw in ((e_, ff, gate, gsw), (ff, e_, down, dsw)):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand((m, k // 256), generator=gen, device=dev) * 1e-2 + 1e-4
        # the yardstick's operands, dequantized once outside the timed call
        xb = (xq.float() * torch.repeat_interleave(xs, 256, dim=1)).to(bf16)
        wg = k_major((w.float() * torch.repeat_interleave(sw, 256, dim=1)).to(bf16))
        for name, sizes in size_sets.items():
            ok &= ragged_i8_case(torch, timer, results, xq, xs, w, sw, xb, wg, sizes,
                                 f"M={m} K={k} N={n} {name}")
            if (k, name) == (e_, "skewed"):
                gs = torch.from_numpy(sizes.astype(np.int32)).to(dev)
                a10 = (xq, xs.t(), w, sw, gs)
                flush_check(timer, f"10 M={m} K={k} N={n} {name}",
                            kernel=lambda: MQ.ragged_qmatmul_i8(*a10),
                            library=lambda: grouped_library(xb, wg, gs))
        del wg
    return ok


def ragged_i8_case(torch, timer, results, xq, xs, w, sw, xb, wg, sizes, case: str) -> bool:
    """One kernel 10 case: xq int8 (M, K), xs f32 (M, K/256), w codes (G, K,
    N), sw (G, K/256, N), xb and wg the yardstick's dequantized rows and
    experts (k_major), sizes the group sizes (numpy). The live rows must be
    the plain version's bits and two calls must repeat them; the error is
    logged against the float32 reassociation bound of the first port's
    check."""
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    (m, k), (g_, _, n) = xq.shape, w.shape
    gs = torch.from_numpy(np.asarray(sizes).astype(np.int32)).to(xq.device)
    total, ne = int(np.sum(sizes)), int((np.asarray(sizes) > 0).sum())
    a10 = (xq, xs.t(), w, sw, gs)
    got = MQ.ragged_qmatmul_i8(*a10)
    again = MQ.ragged_qmatmul_i8(*a10)
    ref = MQ.ragged_qmatmul_i8_ref(xq, xs, w, sw, gs)
    sync(torch)
    same = bool(torch.equal(got[:total], ref[:total]))
    rep = bool(torch.equal(got[:total], again[:total]))
    err = float((got[:total] - ref[:total]).abs().max()) if total else 0.0
    tol = 1e-5 * (float(ref[:total].abs().max()) if total else 0.0) + 1e-6
    nk = k // 256
    bnd = bound_ms(total * k + total * nk * 4 + ne * (k * n + nk * n * 4)
                   + total * n * 4 + g_ * 4, 2.0 * total * k * n, INT8_OPS)
    plan = MQ.ragged_i8_plan(m, n, k, g_, MQ._cuda.sm_count(xq))
    ok = _record(results, "ragged_qmatmul_i8", case, err, tol,
                 timer(lambda: MQ.ragged_qmatmul_i8(*a10)),
                 timer(lambda: MQ.ragged_qmatmul_i8_ref(xq, xs, w, sw, gs), 3),
                 time_grouped(timer, xb, wg, gs, f"kernel 10 {case}"),
                 bnd, note=f" | plan: sweeps of {plan['tn']} columns by {plan['tm']} tokens "
                           f"on {plan['blocks']} blocks; {ne} experts with rows, at most "
                           f"{int(np.max(sizes)) if g_ else 0}; bit-identical to plain: {same}; "
                           f"repeats bit for bit: {rep}")
    return ok and same and rep


def ragged_case(torch, timer, results, x, codes, sc, wg, sizes, name: str) -> bool:
    """One kernel 14 case against its plain version and the grouped library
    call: x (M, K) bf16, codes (G, K, N), scales (G, K/32, N), wg the
    experts dequantized (k_major), sizes the group sizes (numpy). Checks
    that two calls repeat bit for bit."""
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import _cuda
    (m, k), (g_, _, n) = x.shape, codes.shape
    gsz = torch.from_numpy(sizes.astype(np.int32)).to(x.device)
    total, ne = int(sizes.sum()), int((sizes > 0).sum())
    got = MQ.ragged_qmatmul(x, codes, sc, gsz, group=32)
    ref = MQ.ragged_qmatmul_ref(x, codes, sc, gsz, group=32)
    again = bool(torch.equal(got[:total], MQ.ragged_qmatmul(x, codes, sc, gsz, group=32)[:total]))
    sync(torch)
    err = float((got[:total] - ref[:total]).abs().max()) if total else 0.0
    if not again:
        err = float("inf")
    # the largest sum of |x w| over the live rows, from their own experts
    absdot = float(MQ.ragged_qmatmul_ref(x.abs(), codes.abs(), sc, gsz, group=32)
                   [:total].max()) if total else 0.0
    bnd = bound_ms(total * k * 2 + ne * (k * n + (k // 32) * n * 2) + total * n * 4
                   + g_ * 4, 2.0 * total * k * n, BF16_FLOPS)
    plan = MQ.ragged_plan(m, n, k, g_, 32, sc.element_size(), _cuda.sm_count(x))
    note = (f" | plan: {plan['kernel']}" + (f", sweeps of {plan['tn']} columns by {plan['tm']} "
                                            f"tokens on {plan['blocks']} blocks"
                                            if plan["kernel"] == "wgmma" else "")
            + f"; {ne} experts with rows, at most {int(sizes.max()) if g_ else 0}; "
              f"repeats bit for bit: {again}")
    return _record(results, "ragged_qmatmul", f"M={m} K={k} N={n} G={g_} group=32 {name}", err,
                   sum_tol(k, absdot) + 1e-12,
                   timer(lambda: MQ.ragged_qmatmul(x, codes, sc, gsz, group=32)),
                   timer(lambda: MQ.ragged_qmatmul_ref(x, codes, sc, gsz, group=32), 3),
                   time_grouped(timer, x, wg, gsz, f"kernel 14 K={k} N={n} {name}"), bnd,
                   note=note)


def phase_planar_moe_kernels(torch, timer, results, dev="cuda") -> bool:
    """Kernels 12-14 (planar MoE decode and prefill), 11 (the single-kernel
    int8 decode) and 16 (the pair form of the planar GEMM) against their
    plain versions, at the shapes of Qwen1.5-MoE-A2.7B (60 experts, E 2048,
    FF 1408: gate/up supergroup with f32 scales, down group 32 with bf16
    scales) and of Qwen3-30B-A3B (128 experts, FF 768). Library yardsticks
    are bf16 torch.bmm calls over the same rows and the gathered,
    dequantized experts (11-13: a comparable function, not the same), one
    bf16 grouped product over the same rows, group sizes and dequantized
    experts (14), and a dense bf16 torch.matmul (16)."""
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    from ik_llama_cpp_tpu_torch.tools import perf_dequant as PD
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    ok = True

    def planar(g_, k, n, group, sdtype):
        """(codes (G, K, N) as the view of (G, N, K), scales (G, K/group, N))."""
        lim = 127 if group == 256 else 8
        codes = torch.randint(-lim, lim + 1, (g_, n, k), generator=gen, device=dev,
                              dtype=torch.int8).transpose(1, 2)
        sc = (torch.rand((g_, k // group, n), generator=gen, device=dev) + 0.5) \
            * (0.3 / lim / k ** 0.5)
        return codes, sc.to(sdtype)

    def routed(g_, t, topk):
        return torch.from_numpy(np.concatenate(
            [rng.permutation(g_)[:topk] for _ in range(t)]).astype(np.int32)).to(dev)

    log("[3] kernel 12 (moe_decode_gate_up, planar) vs plain; library = bf16 torch.bmm "
        "over the gathered pairs' dequantized gate|up")
    q2, q3, glm = Q2MOE, MOE, GLM_AIR
    # rows 12a / 13a: GLM-4.5-Air's experts (phase 21: gate / up int8 by
    # supergroups with f32 scales, down planar group 32) at the decode and
    # MTP draft step (P 8) and the verify chunk and MTP refresh of 8 rows (P 64)
    for c, t, group, sdt in ((q2, 1, 256, torch.float32), (q3, 1, 32, bf16),
                             (q2, 8, 256, torch.float32), (glm, 1, 256, torch.float32),
                             (glm, 8, 256, torch.float32)):
        g_, k, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
        p = t * topk
        gate, gs = planar(g_, k, ff, group, sdt)
        up, us = planar(g_, k, ff, group, sdt)
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        x = torch.randn((p, k), generator=gen, device=dev).to(bf16)
        a12 = (x, ids, gate, gs, up, us)
        got = MD.moe_decode_gate_up(*a12, group=group)
        ref = MD.moe_decode_gate_up_ref(*a12, group=group)
        sync(torch)
        err = float((got.float() - ref.float()).abs().max())
        tol = 2.0 ** -7 * float(ref.float().abs().max())   # h is bf16: two ulps of the largest
        sb = gs.element_size()
        bnd = bound_ms(p * k * 2 + p * 4 + nd * 2 * (k * ff + (k // group) * ff * sb)
                       + p * ff * 2, 4.0 * p * k * ff, BF16_FLOPS)
        li = ids.long()
        wb = torch.cat([MD.dequant_experts(gate[li], gs[li], group),
                        MD.dequant_experts(up[li], us[li], group)], dim=2)
        xb = x[:, None, :]
        rep = bool(torch.equal(got, MD.moe_decode_gate_up(*a12, group=group)))
        ok &= rep
        plan = MD.gate_up_plan(p, k, ff)
        ok &= _record(results, "moe_decode_gate_up",
                      f"P={p} K={k} FF={ff} G={g_} group={group} "
                      f"{'f32' if sdt == torch.float32 else 'bf16'} scales", err, tol,
                      timer(lambda: MD.moe_decode_gate_up(*a12, group=group)),
                      timer(lambda: MD.moe_decode_gate_up_ref(*a12, group=group), 3),
                      timer(lambda: torch.bmm(xb, wb)), bnd,
                      note=f" | {plan_text(plan)}; repeats bit for bit: {rep}")
        if c is not glm:
            gate_up_sweep(timer, MD, MD.gate_up_plan, f"kernel 12 P={p}", p, k, ff,
                          lambda: MD.moe_decode_gate_up(*a12, group=group))
        del wb, gate, up

    log("[3] kernel 13 (moe_decode_down, planar) vs plain; library = bf16 torch.bmm over "
        "the gathered pairs' dequantized down")
    for c, t in ((q2, 1), (q3, 1), (q2, 8), (glm, 1), (glm, 8)):
        g_, e_, ff, topk = c["G"], c["E"], c["FF"], c["TOPK"]
        p = t * topk
        down, ds = planar(g_, ff, e_, 32, bf16)
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        hw = torch.randn((p, ff), generator=gen, device=dev).to(bf16)
        got = MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32)
        ref = MD.moe_decode_down_ref(hw, ids, down, ds, top_k=topk, group=32)
        li = ids.long()
        wb = MD.dequant_experts(down[li], ds[li], 32)
        absdot = float(torch.bmm(hw.float().abs()[:, None], wb.float().abs())
                       .reshape(t, topk, e_).sum(1).max())
        sync(torch)
        err = float((got - ref).abs().max())
        bnd = bound_ms(p * ff * 2 + p * 4 + nd * (ff * e_ + (ff // 32) * e_ * 2) + t * e_ * 4,
                       2.0 * p * ff * e_, BF16_FLOPS)
        hb = hw[:, None, :]
        again = MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32)
        rep = bool(torch.equal(got, again))
        ok &= rep
        ok &= _record(results, "moe_decode_down",
                      f"P={p} FF={ff} E={e_} G={g_} group=32 bf16 scales", err,
                      sum_tol(ff * topk, absdot),
                      timer(lambda: MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32)),
                      timer(lambda: MD.moe_decode_down_ref(hw, ids, down, ds, top_k=topk,
                                                           group=32), 3),
                      timer(lambda: torch.bmm(hb, wb)), bnd,
                      note=f" | {plan_text(MD.down_plan(t, topk, ff, e_, 32))}; "
                           f"repeats bit for bit: {rep}")
        if c is not glm:
            cols_sweep(timer, MD, f"kernel 13 P={p} FF={ff}", t, topk, ff, e_, 32,
                       lambda: MD.moe_decode_down(hw, ids, down, ds, top_k=topk, group=32))
        if (c, t) == (q2, 1):
            flush_check(timer, f"13 P={p} FF={ff} E={e_}",
                        kernel=lambda: MD.moe_decode_down(hw, ids, down, ds, top_k=topk,
                                                          group=32),
                        library=lambda: torch.bmm(hb, wb))
        del wb, down

    log("[3] kernel 14 (ragged_qmatmul, planar; ragged_wgmma_kernel where ragged_plan "
        "takes the shape) vs plain; library = bf16 grouped product over the live experts "
        "(torch._grouped_mm of the rows and the dequantized experts)")
    for c, k, n in ((q2, q2["FF"], q2["E"]), (q3, q3["E"], q3["FF"])):
        g_ = c["G"]
        m = PREFILL * c["TOPK"]
        codes, sc = planar(g_, k, n, 32, bf16)
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wg = k_major(MD.dequant_experts(codes, sc, 32))      # dequantized once, not timed
        harm = 1.0 / np.arange(1, g_ + 1)
        size_sets = {"random": rng.multinomial(m, np.full(g_, 1.0 / g_)),
                     "skewed": rng.permutation(rng.multinomial(m, harm / harm.sum())),
                     "zero": np.zeros(g_, np.int64)}
        for name, sizes in size_sets.items():
            if c is q3 and name != "skewed":
                continue
            ok &= ragged_case(torch, timer, results, x, codes, sc, wg, sizes, name)
        del codes, wg

    # rows 10a / 14a: GLM-4.5-Air's sorted MoE chain (phase 21), the int8
    # gate / up on kernel 10 and the planar down on kernel 14, at the verify
    # chunk of 16 rows (128 pairs, each token's 8 experts distinct) and at the
    # 512-token prefill chunk and MTP warm-up (4,096 pairs, skewed)
    log("[3] kernels 10 and 14 at GLM-4.5-Air's experts (128 top-8, E 4096, FF 1408; "
        "rows 10a, 14a): the 16-row verify chunk and the 512-token prefill; library as for "
        "10 and 14")
    g_, e_, ff, topk = glm["G"], glm["E"], glm["FF"], glm["TOPK"]
    harm = 1.0 / np.arange(1, g_ + 1)
    size_sets = {"verify": np.bincount(routed(g_, GLM_VERIFY_ROWS[-1], topk).cpu().numpy(),
                                       minlength=g_),
                 "skewed": rng.permutation(rng.multinomial(PREFILL * topk, harm / harm.sum()))}
    gate, gsw = planar(g_, e_, ff, 256, torch.float32)
    wg = k_major((gate.float() * torch.repeat_interleave(gsw, 256, dim=1)).to(bf16))
    for name, sizes in size_sets.items():
        m = int(sizes.sum())
        xq = torch.randint(-127, 128, (m, e_), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand((m, e_ // 256), generator=gen, device=dev) * 1e-2 + 1e-4
        xb = (xq.float() * torch.repeat_interleave(xs, 256, dim=1)).to(bf16)
        ok &= ragged_i8_case(torch, timer, results, xq, xs, gate, gsw, xb, wg, sizes,
                             f"M={m} K={e_} N={ff} G={g_} {name}")
    del gate, wg
    down, dsc = planar(g_, ff, e_, 32, bf16)
    wg = k_major(MD.dequant_experts(down, dsc, 32))
    for name, sizes in size_sets.items():
        x = torch.randn((int(sizes.sum()), ff), generator=gen, device=dev).to(bf16)
        ok &= ragged_case(torch, timer, results, x, down, dsc, wg, sizes, name)
    del down, wg

    log("[3] kernel 11 (moe_decode_fused_i8, one launch) vs plain, beside kernels 7 + 8 "
        "on the same inputs; library = bf16 torch.bmm over the gathered gate|up, then down")
    g_, e_, ff, topk = q3["G"], q3["E"], q3["FF"], q3["TOPK"]
    gate, gsw = planar(g_, e_, ff, 256, torch.float32)
    up, usw = planar(g_, e_, ff, 256, torch.float32)
    down, dsw = planar(g_, ff, e_, 256, torch.float32)
    nsg, nsgf = e_ // 256, ff // 256
    for t in (1, 8):
        p = t * topk
        ids = routed(g_, t, topk)
        nd = len(set(ids.tolist()))
        x = torch.randn((p, e_), generator=gen, device=dev)
        wts = torch.rand(p, generator=gen, device=dev) * 0.5 + 0.05
        xq, xs = quantize_activations(x)
        a11 = (xq, xs.t(), ids, wts, gate, gsw, up, usw, down, dsw)
        got = MD.moe_decode_fused_i8(*a11, top_k=topk)
        again = MD.moe_decode_fused_i8(*a11, top_k=topk)
        ref = MD.moe_decode_fused_i8_ref(*a11, top_k=topk)
        sync(torch)
        err = float((got - ref).abs().max())
        rep = bool(torch.equal(got, again))
        ok &= rep
        # the same exact integer dots, corrections, bf16 roundings and
        # requantization in the same order as the plain version: only a
        # float32 reassociation may differ
        tol = 1e-5 * float(ref.abs().max()) + 1e-6

        def two_kernels():
            h = MD.moe_decode_gate_up_i8(xq, xs.t(), ids, gate, gsw, up, usw)
            h = (h.float() * wts[:, None]).to(bf16)
            hq, hs = quantize_activations(h)
            return MD.moe_decode_down_i8(hq, hs.t(), ids, down, dsw, top_k=topk)

        ms78 = timer(two_kernels)
        bnd = bound_ms(p * e_ + p * nsg * 4 + 2 * p * 4
                       + nd * (2 * e_ * ff + 2 * nsg * ff * 4 + ff * e_ + nsgf * e_ * 4)
                       + t * e_ * 4, p * (4.0 * e_ * ff + 2.0 * ff * e_), INT8_OPS)
        li = ids.long()
        wgu = torch.cat([gate[li], up[li]], dim=2).to(bf16)
        wdn = down[li].to(bf16)
        xb = x.to(bf16)[:, None, :]
        hb = torch.randn((p, 1, ff), generator=gen, device=dev).to(bf16)
        ok &= _record(results, "moe_decode_fused_i8",
                      f"P={p} K={e_} FF={ff} E={e_} G={g_}", err, tol,
                      timer(lambda: MD.moe_decode_fused_i8(*a11, top_k=topk)),
                      timer(lambda: MD.moe_decode_fused_i8_ref(*a11, top_k=topk), 3),
                      timer(lambda: (torch.bmm(xb, wgu), torch.bmm(hb, wdn))), bnd,
                      note=f" | kernels 7 + 8 with the glue between them {ms78:.4f} ms; "
                           f"{MD.fused_decode_plan(t, topk, ff, e_)['blocks']} blocks; "
                           f"bit-identical to plain: {bool(torch.equal(got, ref))}; "
                           f"repeats bit for bit: {rep}")
        del wgu, wdn
    del gate, up, down

    log("[3] kernel 16 (qmatmul_pair, two codes a 16-bit lane) vs plain, beside kernel D "
        "on the same codes; library = dense bf16 torch.matmul at the same (M, K, N)")
    k, n = E, FF
    codes_np = rng.integers(-128, 128, (k, n), dtype=np.int8)
    codes = torch.from_numpy(codes_np).to(dev)
    packed = torch.from_numpy(PD.pack_pairs(codes_np)).to(dev)
    scale = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.02).to(bf16)
    wb = torch.randn((k, n), generator=gen, device=dev).to(bf16)
    absw = QM._dequant_bf16(codes, scale, None, 32).float().abs()
    for m in (1, 16, 64):
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        got = PD.qmatmul_pair(x, packed, scale)
        ref = PD.qmatmul_pair_ref(x, packed, scale)
        same_as_d = bool(torch.equal(got, QM.qmatmul(x, codes, scale)))
        again = bool(torch.equal(got, PD.qmatmul_pair(x, packed, scale)))
        absdot = float((x.float().abs() @ absw).max())
        sync(torch)
        err = float((got - ref).abs().max())
        ms_d = timer(lambda: QM.qmatmul(x, codes, scale))
        bnd = bound_ms(m * k * 2 + k * n + (k // 32) * n * 2 + m * n * 4, 2.0 * m * n * k,
                       BF16_FLOPS)
        ok &= same_as_d and again
        ok &= _record(results, "qmatmul_pair", f"M={m} K={k} N={n}", err, sum_tol(k, absdot),
                      timer(lambda: PD.qmatmul_pair(x, packed, scale)),
                      timer(lambda: PD.qmatmul_pair_ref(x, packed, scale), 3),
                      timer(lambda: torch.matmul(x, wb)), bnd,
                      note=f" | kernel D on the unpacked codes {ms_d:.4f} ms; "
                           f"bit-identical to kernel D: {same_as_d}; repeats bit for bit: {again}")
    del codes, packed, wb, absw
    return ok


def phase_quantizers(torch) -> bool:
    """The eager quantizers around the kernels (activations per supergroup,
    the requantization of h, the four KV encoders) give the CPU's bits on
    the card: scales are true float32 divisions there too."""
    from ik_llama_cpp_tpu_torch.ops.kv_quant import KV_ENCODERS
    from ik_llama_cpp_tpu_torch.ops.moe_decode import requant_by_inverse
    from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((256, 2048)) * 3)
                         .astype(np.float32))
    fns = {"quantize_activations": (quantize_activations, x),
           "requant_by_inverse": (requant_by_inverse, x)}
    fns.update({f"kv encoder {k}": (enc, x.reshape(4, 64, 16, 128))
                for k, enc in KV_ENCODERS.items()})
    bad = []
    for name, (fn, arg) in fns.items():
        (qc, sc), (qg, sg) = fn(arg), fn(arg.cuda())
        if not (torch.equal(sc, sg.cpu()) and torch.equal(qc, qg.cpu())):
            bad.append(name)
    # the loader's supergroup recode on the card against the numpy recode
    from ik_llama_cpp_tpu_torch.ops.qmatmul import requant_rows, requant_supergroup
    rng = np.random.default_rng(5)
    codes = rng.integers(-128, 128, (3000, 3840), dtype=np.int8)
    scale = (rng.random((3000, 3840 // 32), dtype=np.float32) * 0.05).astype(np.float32)
    q8, sw = requant_rows(codes, scale, 32, "cuda", chunk=1024)
    nq, nsw = requant_supergroup(codes.T, scale.T, group=32)
    if not (np.array_equal(q8.cpu().numpy(), nq.T) and np.array_equal(sw.cpu().numpy(), nsw.T)):
        bad.append("requant_rows")
    log(f"[3] quantizers on the card against the CPU, codes and scales bit for bit "
        f"({', '.join(fns)}, requant_rows): {'ok' if not bad else 'FAIL ' + str(bad)}")
    return not bad


def phase_kvq_kernels(torch, timer, results) -> bool:
    """Kernels 5 (decode attention over a quantized slab, four codecs), 6
    (prefill attention over an int8 cache) and 15 (4-bit packed GEMM)
    against their plain versions at the dense path's shapes."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import kv_quant as KQ
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    scale_ = 1.0 / float(np.sqrt(D))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True

    def attn_case(kernel, fn, codec, b, t, s, qpos, kvlen, **kw):
        q = torch.randn((b, t, H, D), generator=gen, device="cuda").to(bf16)
        # the layer slab is a view of a stacked cache, as on the main path
        enc = KQ.KV_ENCODERS[codec]
        kq, ks = enc(torch.randn((2, b, s, HKV, D), generator=gen, device="cuda"))
        vq, vs = enc(torch.randn((2, b, s, HKV, D), generator=gen, device="cuda"))
        kq, ks, vq, vs = kq[1], ks[1], vq[1], vs[1]
        qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        args = (q, kq, ks, vq, vs, qp, kl)
        got = fn(*args, scale=scale_, **kw)
        ref = FA.attention_quant_ref(*args, scale=scale_, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        # p is rounded to bf16 before the PV product and the output is bf16:
        # two bf16 ulps at the largest output
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        # library: the slab dequantized to bf16, then SDPA with an explicit
        # mask (mask and GQA repeat not timed); and SDPA alone
        pos = torch.arange(s, device="cuda")
        qpos_t = qp[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos_t[:, :, None]) & (pos[None, None, :] < kl[:, None, None])
        swa = kw.get("swa_window", 0)
        if swa:
            mask &= pos[None, None, :] > qpos_t[:, :, None] - swa
        m4 = mask[:, None]
        qt = q.transpose(1, 2)
        dec = KQ.KV_DECODERS[codec]

        def lib_full():
            kr = dec(kq, ks).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
            vr = dec(vq, vs).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4, scale=scale_)

        kr = dec(kq, ks).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        vr = dec(vq, vs).to(bf16).repeat_interleave(H // HKV, dim=2).transpose(1, 2)
        lib = timer(lib_full)
        sdpa = timer(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=m4,
                                                            scale=scale_))
        del kr, vr
        live = int(mask.sum())               # (query, key) pairs this run needs
        lo = [max(0, qpos[i] - swa + 1) if swa else 0 for i in range(b)]
        keys = sum(min(kvlen[i], qpos[i] + t) - lo[i] for i in range(b))
        row_bytes = kq.shape[-1] + vq.shape[-1] + 8          # codes + two f32 scales
        bnd = bound_ms(2 * (b * t * H * D * 2) + keys * HKV * row_bytes,
                       4.0 * H * D * live, BF16_FLOPS)
        extra = "".join(f" {k}" for k in kw)
        case = f"{codec} B={b} T={t} S={s} q_pos0={qpos} kv_len={kvlen}{extra}"
        note = f" | SDPA alone {sdpa:.4f} ms"
        if fn is FA.flash_attention_decode_q8:
            again = bool(torch.equal(got, fn(*args, scale=scale_, **kw)))
            plan = FA.decode_split_plan(b, t, H, HKV, s, D, D, sms)
            blocks = [len(FA.decode_key_ranges(plan, lo[i], min(kvlen[i], qpos[i] + t)))
                      for i in range(b)]
            note += (f" | plan: {plan['splits']} splits x {plan['groups']} groups, round "
                     f"{plan['round']} keys, blocks working a group {blocks}; repeats bit for "
                     f"bit: {again}")
            if not again:
                err = float("inf")
        if fn is FA.flash_attention_q8:
            # both forms of the block run each warp's arithmetic unchanged:
            # the same bits for 1 or 2 query heads a block
            again = bool(torch.equal(got, fn(*args, scale=scale_, **kw)))
            row, same, want = [], True, FA.Q8_HEADS
            for n in (1, 2):
                with forced_heads(FA, n):
                    same &= bool(torch.equal(got, fn(*args, scale=scale_, **kw)))
                    row.append(f"{n}{'*' if n == want else ''} "
                               f"{timer(lambda: fn(*args, scale=scale_, **kw), 5):.4f}")
            note += (f" | ms by query heads a block: {', '.join(row)}; the same bits in every "
                     f"form: {same}; repeats bit for bit: {again}")
            if not (again and same):
                err = float("inf")
        return _record(results, kernel, case, err, tol,
                       timer(lambda: fn(*args, scale=scale_, **kw)),
                       timer(lambda: FA.attention_quant_ref(*args, scale=scale_, **kw), 3),
                       lib, bnd, note=note)

    log("[3] kernel 5 (flash_attention_decode_q8, split-K fa_decode_q_kernel, codecs "
        "q8/q4/q6/nl4) vs plain; library = the slab dequantized to bf16 + SDPA (both timed "
        "together)")
    for codec in ("q8", "q4", "q6", "nl4"):
        for t in (1, 8):
            for s, kvl in ((1024, 513), (4096, 4000)):
                ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8,
                                codec, 1, t, s, [kvl - t], [kvl])
    sinks = torch.randn(H, generator=gen, device="cuda")
    ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8, "q6",
                    1, 1, 1024, [512], [513], sinks=sinks, swa_window=256)
    # row 5s: a speculative verify block of W = 9 over a q8 cache (phase 20 (f))
    ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8, "q8",
                    1, 9, 4096, [3991], [4000])
    for codec in ("q8", "q4", "q6", "nl4"):
        ok &= attn_case("flash_attention_decode_q8", FA.flash_attention_decode_q8, codec,
                        1, 1, 4096, [3999], [4000], sinks=sinks, swa_window=1000)
    log("[3] kernel 6 (flash_attention_q8, prefill over int8 KV) vs plain; library as for 5, "
        "without the sinks and the softcap, which SDPA does not take (so the case with them "
        "is held to a yardstick that does less work)")
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 1024, [0], [512])
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 1024, [256], [768])
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 1024, [256], [768],
                    sinks=sinks, swa_window=256, softcap=30.0)
    # row 6L: the last chunk of phase 9's long fill over the q8 cache
    ok &= attn_case("flash_attention_q8", FA.flash_attention_q8, "q8", 1, 512, 4096, [3488],
                    [4000])

    ok &= phase_qmatmul4(torch, timer, results, gen)
    return ok


# the dense 8B model's decode linears: fused qkv, wo, fused gate/up, down
DECODE_SHAPES = [(E, (H + 2 * HKV) * D), (E, E), (E, 2 * FF), (FF, E)]


def phase_qmatmul4(torch, timer, results, gen) -> bool:
    """Kernel 15 against its plain version: the four decode shapes at M 1, 8
    and 16 (the GEMV kernel) and 512 (the tiled one), with and without a
    codebook, a bias, the head; two calls bit for bit; then the K split
    against the time at M <= 16, and the GEMV kernel's instructions a
    weight from its SASS."""
    from ik_llama_cpp_tpu_torch.ops import kv_quant as KQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.ops import _cuda
    bf16 = torch.bfloat16
    ok = True
    log("[3] kernel 15 (qmatmul4, 4-bit packed, group 32) vs plain; library = dense bf16 "
        "torch.matmul at the same (M, K, N) with the weights already in bf16. M <= 16 runs "
        "qmatmul4_gemv_kernel (K split over a cluster of `splits` blocks), M > 16 "
        "qmatmul4_wgmma_kernel (persistent grid, tiled_plan; row qmatmul4_wgmma); bound = the "
        "larger of the bytes read once (packed, scales, x, out) and the bf16 operations")
    log("[3] tiled 15's warpgroup MMAs in SASS: " + sass_opcodes(
        _cuda._lib_path("qmatmul4"), "qmatmul4_wgmma_kernel", "HGMMA"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iq4nl = tuple(float(v) for v in KQ.IQ4NL_VALUES)       # a 16-level codebook
    cases = [(k, n, (1, 8, 16, 512), lut, False) for k, n in DECODE_SHAPES
             for lut in (None, iq4nl)]
    cases += [(E, E, (1, 16), None, True), (E, V, (1, 16), None, False)]
    for k, n, ms, lut, with_bias in cases:
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                               dtype=torch.uint8)
        sc = (torch.rand((k // 32, n), generator=gen, device="cuda")
              * (0.02 if lut is None else 0.002)).to(bf16)
        bias = None
        if with_bias:
            bias = (torch.randn((k // 32, n), generator=gen, device="cuda") * 0.01).to(bf16)
        wb = torch.randn((k, n), generator=gen, device="cuda", dtype=bf16)
        absw = QM._dequant4_bf16(packed, sc, bias, 32, lut).float().abs()
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            got = QM.qmatmul4(x, packed, sc, bias, lut16=lut)
            ref = QM.qmatmul4_ref(x, packed, sc, bias, lut16=lut)
            again = bool(torch.equal(got, QM.qmatmul4(x, packed, sc, bias, lut16=lut)))
            absdot = float((x.float().abs() @ absw).max())
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            sb = 2 * (2 if bias is not None else 1)
            bnd = bound_ms(m * k * 2 + k * n // 2 + sb * (k // 32) * n + m * n * 4,
                           2.0 * m * n * k, BF16_FLOPS)
            plan = QM.gemv4_plan(m, n, k, 32)
            name, note = dq_record(QM, sms, "qmatmul4", m, n, k, 32,
                                   f" | gemv splits {plan['splits']}" if plan["kernel"] == "gemv"
                                   else " | the mma.sync tiled kernel")
            note += f"; repeats bit for bit: {again}"
            ok &= again
            # both sum the same exact bf16 products in float32 in different
            # orders: 16 sqrt(K) float32 roundings of the largest sum of |x w|
            ok &= _record(results, name, f"M={m} K={k} N={n}"
                          + (" codebook" if lut is not None else "")
                          + (" bias" if bias is not None else ""), err, sum_tol(k, absdot),
                          timer(lambda: QM.qmatmul4(x, packed, sc, bias, lut16=lut)),
                          timer(lambda: QM.qmatmul4_ref(x, packed, sc, bias, lut16=lut), 3),
                          timer(lambda: torch.matmul(x, wb)), bnd, note=note)
        del packed, wb, absw

    log("[3] tiled 15's tile width against its time at M = 512 (ms a call by the tokens of a "
        "tile; * = tiled_plan's choice)")
    for k, n in DECODE_SHAPES:
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                               dtype=torch.uint8)
        sc = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(bf16)
        x = torch.randn((512, k), generator=gen, device="cuda").to(bf16)
        tm_sweep(timer, QM, sms, "15", 512, n, k, lambda: QM.qmatmul4(x, packed, sc))
        del packed

    log("[3] kernel 15's K split against its time at M <= 16 (ms a call by the number of "
        "blocks in a cluster; * = gemv4_plan's choice)")
    for k, n in DECODE_SHAPES:
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                               dtype=torch.uint8)
        sc = (torch.rand((k // 32, n), generator=gen, device="cuda") * 0.02).to(bf16)
        for m in (1, 16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            plan = QM.gemv4_plan(m, n, k, 32)["splits"]
            row = []
            for sp in range(1, QM.GEMV_MAX_SPLITS + 1):
                with forced_splits(QM, sp, "gemv4_plan"):
                    row.append(f"{sp}{'*' if sp == plan else ''} "
                               f"{timer(lambda: QM.qmatmul4(x, packed, sc), 5):.4f}")
            log(f"    M={m} K={k} N={n}: " + ", ".join(row))
        del packed
    log("[3] " + sass_per_weight(_cuda._lib_path("qmatmul4"),
                                 "qmatmul4_gemv_kernelILi1ELi2ELb0ELb0ELb1E", 8))
    return ok


def sass_functions(lib: Path) -> list | None:
    """The SASS of ``lib`` (cuobjdump -sass), one text a function, each
    starting with its mangled name; None without cuobjdump."""
    import re
    import shutil
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    return [f for f in re.split(r"\n\s*Function : ", text) if f.startswith("_")]


def sass_per_weight(lib: Path, kernel: str, weights_per_mma: int) -> str:
    """Instructions a weight in the K loop of ``kernel`` (a mangled-name
    fragment) in the SASS of ``lib`` (cuobjdump -sass): the backward branch
    whose body holds the most HMMA is the K loop; a lane's share of an HMMA
    is ``weights_per_mma`` weights. Counts by opcode beside the total."""
    import re
    funcs = sass_functions(lib)
    if funcs is None:
        return f"SASS of {kernel}: not measured (no cuobjdump)"
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        return f"SASS of {kernel}: not measured (function not found)"
    ins = [(int(a, 16), op.strip()) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]

    def opcode(o):                          # without its predicate and modifiers
        return re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]

    best = None
    for addr, op in ins:
        mt = re.search(r"BRA\s+(0x[0-9a-f]+)", op)
        if mt and int(mt.group(1), 16) < addr:
            lo = int(mt.group(1), 16)
            loop = [o for a, o in ins if lo <= a <= addr]
            n_mma = sum(opcode(o) == "HMMA" for o in loop)
            if n_mma and (best is None or n_mma > best[1]):
                best = (loop, n_mma)
    if best is None:
        return f"SASS of {kernel}: not measured (no loop with HMMA found)"
    loop, n_mma = best
    kinds: dict = {}
    for o in loop:
        kinds[opcode(o)] = kinds.get(opcode(o), 0) + 1
    top = ", ".join(f"{k} {v}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])[:10])
    return (f"SASS of {kernel}: K loop {len(loop)} instructions, {n_mma} HMMA = "
            f"{n_mma * weights_per_mma} weights a lane: "
            f"{len(loop) / (n_mma * weights_per_mma):.3f} instructions a weight ({top})")


def sass_opcodes(lib: Path, kernel: str, prefix: str) -> str:
    """Counts of the SASS instructions of ``kernel`` (a name fragment) in
    ``lib`` whose opcode starts with ``prefix``, by form (cuobjdump -sass)."""
    import re
    funcs = sass_functions(lib)
    if funcs is None:
        return f"SASS of {kernel}: not measured (no cuobjdump)"
    out = []
    for f in funcs:
        head = f.split("\n", 1)[0]
        if kernel not in head:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(" + prefix + r"[\w.]*)", f)
        kinds: dict = {}
        for o in ops:
            kinds[o] = kinds.get(o, 0) + 1
        out.append(f"{demangled(head.strip())}: " + (", ".join(
            f"{k} x{v}" for k, v in sorted(kinds.items())) or f"no {prefix}"))
    return "; ".join(out) or f"SASS of {kernel}: function not found"


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


WORDS = ("the of and to in is was for on that with as by at from his her they have had "
         "not are this which but be were one all their there been has when who will more "
         "no if out so said what up its about into than them can only other new some could "
         "time these two may then do first any my now such like our over man me even most "
         "made after also did many before must through back years where much your way well "
         "down should because each just those people how too little state good very make "
         "world still own see men work long get here between both life being under never "
         "day same another know while last might us great old year off come since against "
         "go came right used take three model server token prompt answer question kernel "
         "request slot batch cache layer weight random seed text word").split()


def spm_vocab(n: int):
    """A synthetic SentencePiece vocabulary of n pieces (tokens, scores,
    types): <unk> <s> </s>, the 256 <0xXX> byte tokens, the printable ASCII
    characters and U+2581, every prefix of each WORDS entry with its
    U+2581 word-start mark and every substring of each word, then
    two- and three-letter pieces drawn from seed 0 up to n. Any text
    round-trips: what no piece covers falls back to byte tokens."""
    rng = np.random.default_rng(0)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    pieces = ["\u2581"] + [chr(c) for c in range(33, 127)]
    for w in WORDS:
        mw = "\u2581" + w
        pieces += [mw[:i] for i in range(2, len(mw) + 1)]
        pieces += [w[i:j] for i in range(len(w)) for j in range(i + 2, len(w) + 1)]
    seen = set(tokens)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(seen) < n:
        for p in pieces:
            if p not in seen and len(tokens) < n:
                seen.add(p)
                tokens.append(p)
                types.append(1)
        size = int(rng.integers(2, 4))
        piece = "".join(rng.choice(letters, size))
        pieces = [piece, "\u2581" + piece]
    scores = [0.0] * 259 + [-float(i) for i in range(n - 259)]
    return tokens, scores, types


def smoke_text(rng, n_words: int) -> str:
    """n_words words of WORDS drawn from rng, with a full stop now and then."""
    words = [str(w) for w in rng.choice(WORDS, n_words)]
    return " ".join(w + ("." if i % 11 == 10 else "") for i, w in enumerate(words))


def build_gguf(path: Path) -> Path:
    """The full-width llama layer as GGUF (one block; Q4_0 planar weights, a
    Q8_0 tied head), random weights from seed 0 and the SentencePiece
    vocabulary of spm_vocab; cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    from ik_llama_cpp_tpu_torch.quant.quantize import quantize
    meta = json.dumps(dict(v=GGUF_VERSION, E=E, H=H, HKV=HKV, FF=FF, V=V))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    w = GGUFWriter(str(path), arch="llama")
    for key, val in (("block_count", 1), ("context_length", 8192),
                     ("embedding_length", E), ("feed_forward_length", FF),
                     ("attention.head_count", H), ("attention.head_count_kv", HKV),
                     ("attention.layer_norm_rms_epsilon", 1e-5),
                     ("rope.freq_base", 500000.0), ("rope.dimension_count", D),
                     ("vocab_size", V)):
        w.add(f"llama.{key}", val)
    tokens, scores, types = spm_vocab(V)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0):
        arr = rng.standard_normal((rows, cols), dtype=np.float32) / np.sqrt(cols)
        w.add_tensor(name, quantize(arr, ttype), shape=(cols, rows), ggml_type=ttype)

    q("token_embd.weight", V, E, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(E, np.float32))
    p = "blk.0."
    w.add_tensor(p + "attn_norm.weight", np.ones(E, np.float32))
    w.add_tensor(p + "ffn_norm.weight", np.ones(E, np.float32))
    q(p + "attn_q.weight", E, E)
    q(p + "attn_k.weight", HKV * D, E)
    q(p + "attn_v.weight", HKV * D, E)
    q(p + "attn_output.weight", E, E)
    q(p + "ffn_gate.weight", FF, E)
    q(p + "ffn_up.weight", FF, E)
    q(p + "ffn_down.weight", E, FF)
    w.write()
    mpath.write_text(meta)
    return path


def _rand_blocks(rng, rows: int, cols: int, ttype) -> np.ndarray:
    """Random Q4_0 / Q8_0 blocks of a (rows, cols) weight, written directly
    (uniform codes, f16 scales sized for weights of about 1/sqrt(cols))
    so that a 1 GB file takes seconds; loading still runs the planar
    decode and the supergroup recode."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    width, code_std = (16, 4.6) if ttype == GGMLType.Q4_0 else (32, 73.9)
    nb = rows * cols // 32
    d = (rng.uniform(0.5, 1.5, nb) / (code_std * np.sqrt(cols))).astype(np.float16)
    out = np.empty((nb, 2 + width), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:] = rng.integers(0, 256, (nb, width), dtype=np.uint8)
    return out


def build_moe_gguf(path: Path, c=MOE) -> Path:
    """One MoE layer of architecture c["ARCH"] at the width ``c`` (Q4_0
    attention and experts, Q8_0 embedding and untied head, an f32 router,
    unit norms; qwen3moe: QK-norms; qwen2moe: q/k/v biases and a Q4_0
    shared expert of width c["FFS"] with an f32 sigmoid gate), random
    blocks from seed 0; cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=MOE_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    e, h, hkv, d, g, ff, v = (c[k] for k in ("E", "H", "HKV", "D", "G", "FF", "V"))
    arch = c["ARCH"]
    w = GGUFWriter(str(path), arch=arch)
    if "FFS" in c:
        w.add(f"{arch}.expert_shared_feed_forward_length", c["FFS"])
    for key, val in (("block_count", 1), ("context_length", 40960),
                     ("embedding_length", e), ("feed_forward_length", 6144),
                     ("expert_feed_forward_length", ff), ("expert_count", g),
                     ("expert_used_count", c["TOPK"]), ("attention.head_count", h),
                     ("attention.head_count_kv", hkv), ("attention.key_length", d),
                     ("attention.value_length", d),
                     ("attention.layer_norm_rms_epsilon", 1e-6),
                     ("rope.freq_base", 1000000.0), ("rope.dimension_count", d),
                     ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    q("output.weight", v, e, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(e, np.float32))
    p = "blk.0."
    norms = [("attn_norm", e), ("ffn_norm", e)]
    if arch == "qwen3moe":
        norms += [("attn_q_norm", d), ("attn_k_norm", d)]
    for name, width in norms:
        w.add_tensor(p + name + ".weight", np.ones(width, np.float32))
    q(p + "attn_q.weight", h * d, e)
    q(p + "attn_k.weight", hkv * d, e)
    q(p + "attn_v.weight", hkv * d, e)
    q(p + "attn_output.weight", e, h * d)
    w.add_tensor(p + "ffn_gate_inp.weight",
                 rng.standard_normal((g, e), dtype=np.float32) / np.float32(np.sqrt(e)))
    q(p + "ffn_gate_exps.weight", ff, e, n=g)
    q(p + "ffn_up_exps.weight", ff, e, n=g)
    q(p + "ffn_down_exps.weight", e, ff, n=g)
    if arch == "qwen2moe":
        for name, width in (("attn_q", h * d), ("attn_k", hkv * d), ("attn_v", hkv * d)):
            w.add_tensor(p + name + ".bias",
                         (rng.standard_normal(width) * 0.1).astype(np.float32))
        q(p + "ffn_gate_shexp.weight", c["FFS"], e)
        q(p + "ffn_up_shexp.weight", c["FFS"], e)
        q(p + "ffn_down_shexp.weight", e, c["FFS"])
        w.add_tensor(p + "ffn_gate_inp_shexp.weight",
                     rng.standard_normal((1, e), dtype=np.float32) / np.float32(np.sqrt(e)))
    w.write()
    mpath.write_text(meta)
    return path


def clone_layers(rt, n_layer: int):
    """Block 0 cloned into n_layer distinct blocks (no aliasing)."""
    blk0 = rt.params["blocks"][0]
    rt.params["blocks"] = [copy.deepcopy(blk0) for _ in range(n_layer)]
    rt.cfg = replace(rt.cfg, n_layer=n_layer)
    return rt


def counters():
    """{name: (wrapper, the attribute that counts its launches)}"""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    from ik_llama_cpp_tpu_torch.tools import perf_dequant as PD
    fns = {"qmatmul_i8": QM.qmatmul_i8, "flash_attention": FA.flash_attention,
            "flash_attention_decode": FA.flash_attention_decode,
            "qmatmul": QM.qmatmul,
            "flash_attention_decode_q8": FA.flash_attention_decode_q8,
            "flash_attention_q8": FA.flash_attention_q8, "qmatmul4": QM.qmatmul4,
            "moe_decode_gate_up_i8": MD.moe_decode_gate_up_i8,
            "moe_decode_down_i8": MD.moe_decode_down_i8,
            "fused_moe_prefill_i8": MQ.fused_moe_prefill_i8,
            "ragged_qmatmul_i8": MQ.ragged_qmatmul_i8,
            "moe_decode_fused_i8": MD.moe_decode_fused_i8,
            "moe_decode_gate_up": MD.moe_decode_gate_up,
            "moe_decode_down": MD.moe_decode_down,
            "ragged_qmatmul": MQ.ragged_qmatmul, "qmatmul_pair": PD.qmatmul_pair}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    # the M > 16 wgmma kernels of D and 15: the part of their wrappers' launches
    out["qmatmul_wgmma"] = (QM.qmatmul, "wgmma_launches")
    out["qmatmul4_wgmma"] = (QM.qmatmul4, "wgmma_launches")
    # ... and kernel 14's (the mma.sync form runs only shapes TMA cannot address)
    out["ragged_qmatmul_wgmma"] = (MQ.ragged_qmatmul, "wgmma_launches")
    # the MLA form of kernel B (the DeepSeek-2 family's latent cache)
    out["flash_attention_mla"] = (FA.flash_attention, "mla_launches")
    return out


def reset_counts():
    for f, attr in counters().values():
        setattr(f, attr, 0)


def read_counts() -> dict:
    return {k: getattr(f, attr) for k, (f, attr) in counters().items()}


def phase_e2e(torch, gguf: Path, launches: dict) -> bool:
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    log(f"[4] loaded L{NL} E{E} H{H} KV{HKV} FF{FF} V{V} in {load_s:.1f} s "
        f"(numpy planar decode + supergroup recode of one layer, then "
        f"{NL} device clones); linears {kinds}")
    rng = np.random.default_rng(1)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, V, PREFILL)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches.update({k: counts[k] for k in ("qmatmul_i8", "flash_attention",
                                            "flash_attention_decode")})
    per = 4 * NL + 1
    want = dict.fromkeys(counts, 0)
    want.update({"qmatmul_i8": per * (1 + DECODE), "flash_attention": NL,
                 "flash_attention_decode": NL * DECODE})
    log(f"[4] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = "
        f"{PREFILL / pre_s:.1f} tok/s; decode {DECODE} tokens at context "
        f"{PREFILL}: {dec_s * 1e3:.1f} ms = {DECODE / dec_s:.2f} tok/s; "
        f"peak memory {peak:.2f} GiB")
    log(f"[4] launches {counts}; expected {want} (per decode step A = 4*{NL}+1 "
        f"= {per}, C = {NL}; the prefill chunk A = {per}, B = {NL})")
    ok = counts == want
    tail = rt.eval_tokens([int(toks[0, -1])], kv, n_past + DECODE)[0]
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(tail).all())
    in_range = bool(((toks >= 0) & (toks < V)).all())
    log(f"[4] logits finite: {finite}; tokens in vocab: {in_range}; "
        f"first tokens {toks[0, :8].tolist()}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:])
    log(f"[4] decode step: kernel A {a_ms(prof)}; {c_ms(prof)}")
    del kv
    kv = rt.new_cache(1, PREFILL + 8)
    prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                          f"one {PREFILL}-token prefill chunk", "chunk", "4")
    log(f"[4] prefill chunk: kernel B (fa_prefill_kernel) {kernel_ms(prof, 'fa_prefill_kernel'):.3f} "
        f"ms, kernel A {a_ms(prof)}")
    del rt, kv
    torch.cuda.empty_cache()
    return ok and finite and in_range


def a_ms(prof: dict) -> str:
    """Kernel A's ms in a profile, by form."""
    gemv = kernel_ms(prof, "qmatmul_i8_gemv_kernel")
    tiled = kernel_ms(prof, "qmatmul_i8_wgmma_kernel")
    return (f"{gemv + tiled:.3f} ms (qmatmul_i8_gemv_kernel {gemv:.3f}, the tiled "
            f"qmatmul_i8_wgmma_kernel {tiled:.3f})")


def c_ms(prof: dict) -> str:
    """Kernel C's ms in a profile."""
    return f"kernel C (fa_decode_kernel) {kernel_ms(prof, 'fa_decode_kernel<'):.3f} ms"


def timed_run(torch, rt, ids, n_decode: int = DECODE):
    """Prefill ``ids`` then decode n_decode tokens greedily, each half timed
    on the host clock around a synchronize."""
    kv = rt.new_cache(1, len(ids) + DECODE + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = rt._decode_loop(first, kv, n_past, n_decode)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, toks, kv, n_past, t1 - t0, t2 - t1


def profile_decode(torch, rt, kv, n_past: int, tok, steps: int = 8, tag: str = "4",
                   top: int = 12, host: bool = True) -> dict:
    """Device time by kernel over a few decode steps (torch.profiler), and
    the share of the wall time the card was busy."""
    rt._decode_loop(tok, kv, n_past, 2)                  # warm
    return profile_window(torch, lambda: rt._decode_loop(tok, kv, n_past, steps), steps,
                          f"{steps} decode steps", "step", tag, top, host=host)


def profile_window(torch, fn, steps: int, what: str, unit: str, tag: str,
                   top: int = 12, host: bool = True) -> dict:
    """Run fn once under torch.profiler: device time and launches by
    kernel per ``unit``, and the share of the wall time the card was busy.
    ``host=False`` traces the card alone (no host op events: a window of
    many launches then costs seconds less to trace and to sum up).
    Returns {kernel name: ms per unit}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    calls = sum(r[2] for r in rows)
    log(f"[{tag}] profile of {what} (under the profiler): wall {wall * 1e3:.1f} ms, "
        f"kernels {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% busy, "
        f"{100 * (1 - busy / wall):.1f}% idle), {len(rows)} kernel kinds, "
        f"{calls // steps} launches/{unit}")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {us / 1e3 / steps:9.3f} ms/{unit}  {n // steps:5d} calls/{unit}  {key[:90]}")
    return {key: us / 1e3 / steps for key, us, _ in rows}


def kernel_ms(prof: dict, *names: str) -> float:
    """ms per unit of the profiled kernels whose name holds one of ``names``."""
    return sum(ms for key, ms in prof.items() if any(n in key for n in names))


@contextmanager
def plain_path():
    """Route the model through the plain versions on the same tensors."""
    from ik_llama_cpp_tpu_torch.models import deepseek2, llama, qwen3next, weights
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.ops import moe
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops import qmatmul as QM
    saved = (deepseek2.flash_attention, weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
             llama.flash_attention_decode, MD.moe_decode_gate_up_i8,
             MD.moe_decode_down_i8, moe.fused_moe_prefill_i8, moe.ragged_qmatmul_i8,
             weights.qmatmul4, llama.flash_attention_decode_q8, llama.flash_attention_q8,
             MD.moe_decode_gate_up, MD.moe_decode_down, MD.moe_decode_fused_i8,
             moe.ragged_qmatmul, qwen3next.flash_attention, qwen3next.flash_attention_decode)
    weights.qmatmul_i8, weights.qmatmul = QM.qmatmul_i8_ref, QM.qmatmul_ref
    weights.qmatmul4 = QM.qmatmul4_ref
    llama.flash_attention = llama.flash_attention_decode = FA.attention_ref
    deepseek2.flash_attention = FA.attention_ref
    qwen3next.flash_attention = qwen3next.flash_attention_decode = FA.attention_ref
    llama.flash_attention_decode_q8 = llama.flash_attention_q8 = FA.attention_quant_ref
    MD.moe_decode_gate_up_i8 = MD.moe_decode_gate_up_i8_ref
    MD.moe_decode_down_i8 = MD.moe_decode_down_i8_ref
    moe.fused_moe_prefill_i8 = MQ.fused_moe_prefill_i8_ref
    MD.moe_decode_gate_up, MD.moe_decode_down = MD.moe_decode_gate_up_ref, MD.moe_decode_down_ref
    MD.moe_decode_fused_i8, moe.ragged_qmatmul = MD.moe_decode_fused_i8_ref, MQ.ragged_qmatmul_ref
    moe.ragged_qmatmul_i8 = (lambda xq, xst, codes, sw, gs:
                             MQ.ragged_qmatmul_i8_ref(xq, xst.t(), codes, sw, gs))
    try:
        yield
    finally:
        (deepseek2.flash_attention, weights.qmatmul_i8, weights.qmatmul, llama.flash_attention,
         llama.flash_attention_decode, MD.moe_decode_gate_up_i8,
         MD.moe_decode_down_i8, moe.fused_moe_prefill_i8, moe.ragged_qmatmul_i8,
         weights.qmatmul4, llama.flash_attention_decode_q8,
         llama.flash_attention_q8, MD.moe_decode_gate_up, MD.moe_decode_down,
         MD.moe_decode_fused_i8, moe.ragged_qmatmul, qwen3next.flash_attention,
         qwen3next.flash_attention_decode) = saved


def greedy_from(torch, rt, kv, n, last_logits, steps):
    """steps greedy tokens from a filled cache; returns (tokens, the logits
    each token was picked from plus the last step's)."""
    outs, toks = [last_logits], []
    for s in range(steps):
        tok = int(torch.argmax(outs[-1]))
        toks.append(tok)
        outs.append(llama_step(torch, rt, torch.tensor([[tok]], device=rt.device), kv, n + s))
    return toks, torch.stack(outs)


def greedy(torch, rt, ids, steps, with_cache: bool = False):
    kv = rt.new_cache(1, len(ids) + steps + 8)
    logits, kv, n = rt.eval_tokens(ids, kv, 0)
    toks, outs = greedy_from(torch, rt, kv, n, logits[-1], steps)
    return (toks, outs, kv, n + steps) if with_cache else (toks, outs)


def forced_logits(torch, rt, kv, n, last_logits, toks):
    """The logits of feeding ``toks`` one by one from a filled cache: the
    same history for both paths, whatever each would have picked."""
    outs = [last_logits]
    for s, tok in enumerate(toks):
        outs.append(llama_step(torch, rt, torch.tensor([[tok]], device=rt.device), kv, n + s))
    return torch.stack(outs)


def forced_parity(torch, rt, ids, steps: int):
    """Kernel path: prefill ``ids`` and decode ``steps`` greedy tokens. Plain
    path: the same prompt and the same tokens fed back (teacher forcing), so
    every step compares logits over one history. Returns (tokens, kernel
    logits, plain logits, kernel cache, plain cache, n_past)."""
    tk, lk, kvk, n = greedy(torch, rt, ids, steps, with_cache=True)
    with plain_path():
        kvp = rt.new_cache(1, len(ids) + steps + 8)
        logits, kvp, n0 = rt.eval_tokens(ids, kvp, 0)
        lp = forced_logits(torch, rt, kvp, n0, logits[-1], tk)
    return tk, lk, lp, kvk, kvp, n


def parity_verdict(lk, lp):
    """(ok, text): every step's logits within 5% of the largest logit (the
    rule of phase 5: the attention kernels round their probabilities to
    bf16, and a one-ulp bf16 difference can move an activation across an
    int8 rounding step), and where the two paths' greedy picks differ, the
    plain path's top-2 gap there, which the logit error must explain."""
    err = (lk - lp).abs().amax(dim=1)
    scale = float(lp.abs().max())
    top2 = lp.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    same = lk.argmax(dim=1) == lp.argmax(dim=1)
    flips = [(i, round(float(gap[i]), 4), round(float(err[i]), 4))
             for i in range(len(same)) if not bool(same[i])]
    ok = float(err.max()) <= 5e-2 * scale and all(g <= 2 * e for _, g, e in flips)
    text = (f"logits max_abs_err {float(err.max()):.3e} over {len(same)} steps of one "
            f"history (max |logit| {scale:.3f}, tol 5% of it); greedy picks identical at "
            f"{int(same.sum())} of {len(same)} steps"
            + (f", the others at near-ties (step, plain top-2 gap, logit error there): {flips}"
               if flips else ""))
    return ok, text


def phase_parity(torch, gguf: Path) -> bool:
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), 2)
    ids = [int(x) for x in np.random.default_rng(2).integers(3, V, 128)]
    tk, lk = greedy(torch, rt, ids, 16)
    with plain_path():
        tp, lp = greedy(torch, rt, ids, 16)
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    tol = 5e-2 * scale
    same = tk == tp
    log(f"[5] depth-2 parity, kernel path vs plain path: tokens identical over "
        f"16 steps: {same}; logits max_abs_err {err:.3e} (max |logit| "
        f"{scale:.3f}, tol {tol:.3e} = 5% of it: the attention kernel rounds "
        f"its probabilities to bf16, a one-ulp bf16 difference can move an "
        f"activation across an int8 rounding step, and one int8 step is 1/127 "
        f"of its supergroup's absmax)")
    if not same:
        log(f"    kernel {tk}\n    plain  {tp}")
    del rt
    torch.cuda.empty_cache()
    return same and err <= tol


def phase_planar(torch, gguf: Path, launches: dict) -> bool:
    """Phase 6: the exact planar path (int8 path off: every linear a
    QLinear, kernel D). At depth 2, the launch check and the parity of
    every step's logits over one token history; then on the same file
    at the full width of phase 4 (L32): prefill 512 and decode 64 with the
    launch counts, a decode profile (the M <= 16 kernel a step) and a
    prefill profile (the tiled kernel)."""
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = t0 = time.perf_counter()
    weights.set_i8_mxu(False)
    try:
        rt = Runtime.from_gguf(gguf, fuse=True)
    finally:
        weights.set_i8_mxu(None)
    load_s = time.perf_counter() - t0
    rt = clone_layers(rt, 2)
    kinds = _linear_kinds(rt)
    ids = [int(x) for x in np.random.default_rng(3).integers(3, V, 64)]
    reset_counts()
    kv = rt.new_cache(1, 64 + 16)
    logits, kv, n = rt.eval_tokens(ids, kv, 0)
    toks = rt._decode_loop(torch.argmax(logits[-1]).reshape(1, 1), kv, n, 8)
    torch.cuda.synchronize()
    counts = read_counts()
    finite = bool(torch.isfinite(logits).all())
    log(f"[6] planar path (int8 path off, depth 2, linears {kinds}): prefill 64 "
        f"+ 8 decode steps; launches {counts}; logits finite {finite}; tokens "
        f"{toks[0].tolist()}")
    ok = counts["qmatmul"] == 9 * 9 and finite
    del kv
    # the wgmma kernel sums in another order than the plain version: every
    # step's logits over one token history (phase 11's gate)
    pids = [int(x) for x in np.random.default_rng(7).integers(3, V, 128)]
    _, lk, lp, _, _, _ = forced_parity(torch, rt, pids, 16)
    good, text = parity_verdict(lk, lp)
    log(f"[6] depth-2 parity, kernel path vs plain path: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    del lk, lp

    rt = clone_layers(rt, NL)           # block 0 again, into NL blocks
    torch.cuda.synchronize()
    log(f"[6] planar path at full width: L{NL} (loaded in {load_s:.1f} s, cloned in "
        f"{time.perf_counter() - t0 - load_s:.1f} s); device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(6)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, V, PREFILL)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches["qmatmul"] = counts["qmatmul"]
    launches["qmatmul_wgmma"] = counts["qmatmul_wgmma"]
    per = 4 * NL + 1
    want = dict.fromkeys(counts, 0)
    want.update({"qmatmul": per * (1 + DECODE), "qmatmul_wgmma": per, "flash_attention": NL,
                 "flash_attention_decode": NL * DECODE})
    finite = bool(torch.isfinite(logits).all()) and bool(((toks >= 0) & (toks < V)).all())
    log(f"[6] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = {PREFILL / pre_s:.1f} tok/s; "
        f"decode {DECODE} tokens at context {PREFILL}: {dec_s * 1e3:.1f} ms = "
        f"{DECODE / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB")
    log(f"[6] launches {counts}; expected {want} (D = 4*{NL}+1 = {per} a decode step and "
        f"a prefill chunk, the chunk's by the wgmma kernel); logits finite, tokens in vocab: "
        f"{finite}")
    ok &= counts == want and finite
    prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="6")
    log(f"[6] decode step: qmatmul_gemv_kernel {kernel_ms(prof, 'qmatmul_gemv_kernel'):.3f} ms, "
        f"the tiled qmatmul_wgmma_kernel {kernel_ms(prof, 'qmatmul_wgmma_kernel'):.3f} ms")
    ok &= kernel_ms(prof, "qmatmul_gemv_kernel") > 0
    del kv
    kv = rt.new_cache(1, PREFILL + 8)
    prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                          f"one {PREFILL}-token prefill chunk", "chunk", "6")
    log(f"[6] prefill chunk: the tiled qmatmul_wgmma_kernel "
        f"{kernel_ms(prof, 'qmatmul_wgmma_kernel'):.3f} ms, qmatmul_gemv_kernel "
        f"{kernel_ms(prof, 'qmatmul_gemv_kernel'):.3f} ms, the mma.sync qmatmul_kernel "
        f"{kernel_ms(prof, 'qmatmul_kernel<'):.3f} ms")
    del rt, kv
    torch.cuda.empty_cache()
    log(f"[6] planar path: {time.perf_counter() - t_phase:.1f} s")
    return ok


def moe_run(torch, rt, c, seed: int, tag: str, step: dict, chunk: dict, load_s: float):
    """Warm up, then prefill 512 and decode 64 with the launch counts set to
    0 just before and read just after. Returns (ok, counts, ids, toks, kv,
    n_past)."""
    v = c["V"]
    rng = np.random.default_rng(seed)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, v, PREFILL)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, v, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: chunk.get(k, 0) + DECODE * step.get(k, 0) for k in counts}
    log(f"[{tag}] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = {PREFILL / pre_s:.1f} "
        f"tok/s; decode {DECODE} tokens at context {PREFILL}: {dec_s * 1e3:.1f} ms = "
        f"{DECODE / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB; load {load_s:.1f} s")
    log(f"[{tag}] launches { {k: n for k, n in counts.items() if n} }; as expected: "
        f"{counts == want} (per decode step {step}; per {PREFILL}-token chunk {chunk}; "
        f"every other kernel 0)")
    if counts != want:
        log(f"    expected { {k: n for k, n in want.items() if n} }")
    tail = rt.eval_tokens([int(toks[0, -1])], kv, n_past + DECODE)[0]
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(tail).all())
    in_range = bool(((toks >= 0) & (toks < v)).all())
    log(f"[{tag}] logits finite: {finite}; tokens in vocab: {in_range}; first tokens "
        f"{toks[0, :8].tolist()}")
    return counts == want and finite and in_range, counts, ids, toks, kv, n_past


def depth2(torch, rt):
    rt.params["blocks"] = rt.params["blocks"][:2]
    rt.cfg = replace(rt.cfg, n_layer=2)
    torch.cuda.empty_cache()


@contextmanager
def fused_decode_env():
    """IK_MOE_FUSED_TG=1 (read at call time by moe_ffn), restored after."""
    old = os.environ.get("IK_MOE_FUSED_TG")
    os.environ["IK_MOE_FUSED_TG"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["IK_MOE_FUSED_TG"]
        else:
            os.environ["IK_MOE_FUSED_TG"] = old


def phase_moe(torch, gguf: Path, launches: dict, phases: set, c=MOE,
              replay: dict | None = None) -> bool:
    """On one loaded Qwen3-30B-A3B model: phase 7 (full width, launch
    counts, profiles, the router's capacity buckets), phase 14 (the
    single-kernel decode at full width), then at depth 2 phase 8 (greedy
    parity, kernel path against plain path) and phase 13c (parity of the
    single-kernel decode over one history). ``replay`` gets phase 7's
    group sizes a layer and the chunk's kernel-9 and kernel-10 ms (row 9p)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    nl, v = L7, c["V"]
    t_phase = t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), nl)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ex = rt.params["blocks"][0]["experts"]
    log(f"[7] loaded qwen3moe L{nl} E{c['E']} H{c['H']} KV{c['HKV']} D{c['D']} "
        f"experts {c['G']} top-{c['TOPK']} FF{c['FF']} V{v} in {load_s:.1f} s (numpy "
        f"planar decode + supergroup recode of one layer, {nl} device clones); "
        f"expert codes {tuple(ex.gate.shape)} x3, groups {ex.gate_group}; device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = True
    chunk = {"qmatmul_i8": 2 * nl + 1, "flash_attention": nl,
             "fused_moe_prefill_i8": nl, "ragged_qmatmul_i8": 3 * nl}
    two_kernel_ms = step_ms = None
    if 7 in phases:
        step = {"qmatmul_i8": 2 * nl + 1, "flash_attention_decode": nl,
                "moe_decode_gate_up_i8": nl, "moe_decode_down_i8": nl}
        good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 4, "7", step, chunk, load_s)
        ok &= good
        launches.update({k: counts[k] for k in ("moe_decode_gate_up_i8", "moe_decode_down_i8",
                                                "fused_moe_prefill_i8", "ragged_qmatmul_i8")})
        prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="7")
        two_kernel_ms = kernel_ms(prof, "gate_up_i8_kernel", "down_i8_kernel")
        step_ms = sum(prof.values())
        k7, k8 = kernel_ms(prof, "gate_up_i8_kernel"), kernel_ms(prof, "down_i8_kernel")
        log(f"[7] kernel 7 (moe_decode_gate_up_i8, gate_up_i8_kernel): {k7:.3f} ms a decode "
            f"step of {step_ms:.3f} ms of kernels ({100 * k7 / step_ms:.1f}%), "
            f"{counts['moe_decode_gate_up_i8'] / DECODE:g} launches a token")
        log(f"[7] kernel 8 (moe_decode_down_i8, down_i8_kernel): {k8:.3f} ms a decode step "
            f"of {step_ms:.3f} ms of kernels ({100 * k8 / step_ms:.1f}%), "
            f"{counts['moe_decode_down_i8'] / DECODE:g} launches a token")
        log(f"[7] decode step: kernel A {a_ms(prof)}; {c_ms(prof)}")
        del kv
        kv = rt.new_cache(1, PREFILL + 8)
        prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                              f"one {PREFILL}-token prefill chunk", "chunk", "7")
        log(f"[7] prefill chunk: kernel A {a_ms(prof)}")
        k9 = kernel_ms(prof, "fused_prefill_i8_kernel")
        k10 = kernel_ms(prof, "ragged_i8_wgmma_kernel")
        log(f"[7] prefill chunk: kernel 9 (fused_moe_prefill_i8, fused_prefill_i8_kernel) "
            f"{k9:.3f} ms, {counts['fused_moe_prefill_i8']} launches; kernel 10 (the overflow "
            f"pass, ragged_i8_wgmma_kernel) {k10:.3f} ms, {counts['ragged_qmatmul_i8']} "
            f"launches; {sum(prof.values()):.3f} ms of kernels")
        if counts["ragged_qmatmul_i8"] > 0 and k10 <= 0:
            log("[7] FAIL: kernel 10 launched but the chunk's profile holds no time of it")
            ok = False
        del kv
        sizes = router_sizes(torch, rt, ids, "_fused_prefill_try", 1)
        log_buckets(sizes)
        dump = ROOT / "build" / "qwen3moe_router_sizes.json"
        dump.write_text(json.dumps(sizes))
        log(f"[7] the router's group sizes a layer written to {dump} "
            f"(scripts/compare_trees.py time10p replays row 10p from them)")
        if replay is not None:
            replay.update(sizes=sizes, chunk_ms={"9": k9, "10": k10})
        log(f"[7] MoE end to end: {time.perf_counter() - t_phase:.1f} s")
    if 14 in phases:
        t0 = time.perf_counter()
        step = {"qmatmul_i8": 2 * nl + 1, "flash_attention_decode": nl,
                "moe_decode_fused_i8": nl}
        with fused_decode_env():
            good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 14, "14", step, chunk, load_s)
            prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="14")
        ok &= good
        launches["moe_decode_fused_i8"] = counts["moe_decode_fused_i8"]
        fused_ms = kernel_ms(prof, "fused_decode_i8_kernel")
        log(f"[14] single-kernel decode (IK_MOE_FUSED_TG=1) at L{nl}: kernel 11 "
            f"{fused_ms:.3f} ms a step ({nl} launches), every kernel of a step "
            f"{sum(prof.values()):.3f} ms; the two-kernel step of phase 7: kernels 7 + 8 "
            + (f"{two_kernel_ms:.3f} ms, every kernel {step_ms:.3f} ms"
               if two_kernel_ms is not None else "not run")
            + f"; {time.perf_counter() - t0:.1f} s")
        del kv

    depth2(torch, rt)
    ids = [int(x) for x in np.random.default_rng(5).integers(3, v, 128)]
    if 8 in phases:
        t0 = time.perf_counter()
        tk, lk = greedy(torch, rt, ids, 16)
        with plain_path():
            tp, lp = greedy(torch, rt, ids, 16)
        err = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        tol = 5e-2 * scale
        same = tk == tp
        log(f"[8] MoE depth-2 parity, kernel path vs plain path: tokens identical over 16 "
            f"steps: {same}; logits max_abs_err {err:.3e} (max |logit| {scale:.3f}, tol "
            f"{tol:.3e} = 5% of it, the dense rule of phase 5: a one-ulp difference can "
            f"move an activation or a requantized h across an int8 step); "
            f"{time.perf_counter() - t0:.1f} s")
        if not same:
            log(f"    kernel {tk}\n    plain  {tp}")
        ok &= same and err <= tol
    if 13 in phases:
        t0 = time.perf_counter()
        reset_counts()
        with fused_decode_env():
            _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
        counts = read_counts()
        good, text = parity_verdict(lk, lp)
        good &= (counts["moe_decode_fused_i8"] == 2 * 16
                 and counts["moe_decode_gate_up_i8"] == counts["moe_decode_down_i8"] == 0)
        log(f"[13c] Qwen3-30B-A3B shape, single-kernel decode, depth 2, kernel path vs plain "
            f"path: {text}; kernel 11 launched {counts['moe_decode_fused_i8']} times, 7 and "
            f"8 never: {'ok' if good else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
        ok &= good
    del rt
    torch.cuda.empty_cache()
    return ok


def log_buckets(sizes: list, tag: str = "7") -> None:
    """Per layer: the live experts, the rows a live expert puts in its
    bucket, and the rows past the capacity that go to kernel 10."""
    from ik_llama_cpp_tpu_torch.ops.moe import fused_capacity
    per = np.asarray(sizes)
    r = fused_capacity(int(per[0].sum()), per.shape[1])
    live = (per > 0).sum(1)
    in_bucket = np.minimum(per, r)
    over = np.maximum(per - r, 0).sum(1)
    log(f"[{tag}] kernel 9's buckets from the router, {len(sizes)} calls of {int(per[0].sum())} "
        f"rows over {per.shape[1]} experts at capacity {r}: live experts "
        f"{int(live.min())}-{int(live.max())} a layer (mean {live.mean():.1f}); rows in a live "
        f"bucket mean {in_bucket.sum() / max(1, live.sum()):.1f}, max {int(in_bucket.max())}; "
        f"overflow rows to kernel 10 {int(over.min())}-{int(over.max())} a layer (sum "
        f"{int(over.sum())})")
    for i, (gs, n, o) in enumerate(zip(per, live, over)):
        rows = np.minimum(gs[gs > 0], r)
        log(f"    layer {i:2d}: n_live {int(n):3d}, rows a live bucket {rows.mean():5.1f} "
            f"(min {int(rows.min())}, max {int(rows.max())}), overflow {int(o)}")


def fused_buckets(torch, sizes, g_: int, r: int, k: int, gen, dev="cuda"):
    """Capacity buckets as _fused_prefill_try builds them from group sizes:
    random int8 rows (zero past each expert's rows, capped at r), their
    scales, live experts first, and the live count on the device."""
    sz = torch.as_tensor(np.minimum(np.asarray(sizes), r), device=dev)
    valid = torch.arange(r, device=dev)[None, :] < sz[:, None]
    xg = torch.randint(-127, 128, (g_, r, k), generator=gen, device=dev, dtype=torch.int8)
    xg = torch.where(valid[..., None], xg, 0).to(torch.int8)
    xs = torch.rand((g_, r, k // 256), generator=gen, device=dev) * 1e-2 + 1e-4
    xst = torch.where(valid[..., None], xs, 0.0).transpose(1, 2)
    ar = torch.arange(g_, device=dev)
    eids = torch.argsort(torch.where(sz > 0, ar, 2 * g_)).to(torch.int32)
    n_live = int((sz > 0).sum())
    return xg, xst, eids, torch.tensor(n_live, dtype=torch.int32, device=dev), n_live


REPEAT_CALLS = 300      # kernel 9's repeat gate: calls a row, each held to the first


def repeat_gate(torch, timer, fn, first, live, calls: int):
    """Calls ``fn`` ``calls`` times back to back with no host sync between
    them (a clean L2 flush, ``timer``'s, before every other call) and holds
    the live rows of each output to ``first``'s, bit for bit, on the device.
    Returns (calls that differ, the largest difference, the live slots that
    differed at least once)."""
    n = len(live)
    bad = torch.zeros((), dtype=torch.int32, device=first.device)
    worst = torch.zeros((), dtype=torch.float32, device=first.device)
    hit = torch.zeros(n, dtype=torch.bool, device=first.device)
    want = first[live]
    for i in range(calls):
        if i % 2:
            timer.flush.zero_()
            timer.sweep.sum()
        d = (fn()[live] - want).abs().flatten(1)
        bad += (d.amax() != 0).to(torch.int32)
        hit |= d.amax(1) != 0
        worst = torch.maximum(worst, d.amax())
    sync(torch)
    slots = torch.nonzero(hit).flatten().tolist()
    return int(bad), float(worst), slots


def prefill_case(torch, timer, results, a9, n_live: int, r: int, c, case: str) -> bool:
    """One kernel 9 case against its plain version (live rows), repeated for
    its bits, beside the bf16 torch.bmm of the live buckets against their
    gate|up and the byte bound of this call's live experts."""
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    xg, xst, eids, nl, gate, gsw, up, usw, down, dsw = a9
    g_, e_, ff = c["G"], c["E"], c["FF"]
    nsg, nsgf = e_ // 256, ff // 256
    got = MQ.fused_moe_prefill_i8(*a9, capacity=r)
    ref = MQ.fused_moe_prefill_i8_ref(*a9, capacity=r)
    sync(torch)
    live = eids[:n_live].long()
    err = float((got[live] - ref[live]).abs().max()) if n_live else 0.0
    same = bool(torch.equal(got[live], ref[live]))
    bad, worst, slots = repeat_gate(torch, timer, lambda: MQ.fused_moe_prefill_i8(*a9, capacity=r),
                                    got, live, REPEAT_CALLS)
    rep = bad == 0
    log(f"[3] {case}: repeat gate, {REPEAT_CALLS} calls back to back (a clean L2 flush before "
        f"every other one): {bad} differ from the first call"
        + (f", by at most {worst:.4g}, in live slots {slots[:10]}" if bad else ""))
    # a one-ulp float32 difference in the activation can move an h
    # across a bf16 boundary and one requantized h by one int8 step
    tol = 1e-2 * float(ref[live].abs().max()) if n_live else 0.0
    bnd = bound_ms(n_live * (r * e_ + nsg * r * 4) + g_ * 4 + 4
                   + n_live * (2 * e_ * ff + 2 * nsg * ff * 4 + ff * e_ + nsgf * e_ * 4)
                   + n_live * r * e_ * 4, n_live * r * (4.0 * e_ * ff + 2.0 * ff * e_),
                   INT8_OPS)
    wb = torch.cat([gate[live], up[live]], dim=2).to(torch.bfloat16)
    xb = xg[live].to(torch.bfloat16)
    plan = MQ.fused_prefill_plan(r, ff, e_, g_, MQ._cuda.sm_count(xg))
    ok = _record(results, "fused_moe_prefill_i8", case, err, tol,
                 timer(lambda: MQ.fused_moe_prefill_i8(*a9, capacity=r)),
                 timer(lambda: MQ.fused_moe_prefill_i8_ref(*a9, capacity=r), 3),
                 timer(lambda: torch.bmm(xb, wb)), bnd,
                 note=f" | plan mi {plan['mi']} depth {plan['depth']} blocks {plan['blocks']} "
                      f"smem {plan['smem']}; bit-identical to plain: {same}; repeats bit for "
                      f"bit: {REPEAT_CALLS - bad} of {REPEAT_CALLS} calls")
    del wb, xb
    return ok and rep


def phase_replay_9p(torch, timer, results, sizes: list, chunk_ms: dict, c=MOE,
                    row: str = "9p", phase: str = "7") -> bool:
    """Row 9p of phase 3, after phase 7 (row 9q after phase 19): kernel 9 at
    the group sizes the phase's router gave its prefill chunk (capped at
    the bucket capacity), on random codes from a seed at that shape: layer
    0's call against its plain version, the library call and its bound,
    then every layer's call timed alone, summed beside the profiled chunk's
    kernel-9 time."""
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    from ik_llama_cpp_tpu_torch.ops.moe import fused_capacity
    g_, e_, ff = c["G"], c["E"], c["FF"]
    gen = torch.Generator(device="cuda").manual_seed(9)

    def codes(n, k):
        return torch.randint(-127, 128, (g_, n, k), generator=gen, device="cuda",
                             dtype=torch.int8).transpose(1, 2)

    def scales(k, n):
        return torch.rand((g_, k // 256, n), generator=gen, device="cuda") * 2e-3 + 1e-5

    w = (codes(ff, e_), scales(e_, ff), codes(ff, e_), scales(e_, ff), codes(e_, ff),
         scales(ff, e_))
    m = int(np.sum(sizes[0]))
    r = fused_capacity(m, g_)
    xg, xst, eids, nl, n_live = fused_buckets(torch, sizes[0], g_, r, e_, gen)
    log(f"[3] {row}: kernel 9 at the bucket sizes of phase {phase}'s router (layer 0 of "
        f"{len(sizes)}): n_live {n_live}, capacity {r}")
    a9 = (xg, xst, eids, nl) + w
    ok = prefill_case(torch, timer, results, a9, n_live, r, c,
                      f"G={g_} R={r} K={e_} FF={ff} E={e_} phase-{phase} router, layer 0 "
                      f"(n_live={n_live})")
    kern = 0.0
    for gs in sizes:
        xg, xst, eids, nl, _ = fused_buckets(torch, gs, g_, r, e_, gen)
        kern += timer(lambda: MQ.fused_moe_prefill_i8(xg, xst, eids, nl, *w, capacity=r), 5)
    log(f"[3] {row}: the {len(sizes)} layers' calls timed alone (clean flush each): kernel 9 "
        f"{kern:.3f} ms; the profiled chunk's kernel 9 {chunk_ms['9']:.3f} ms, kernel 10 "
        f"{chunk_ms['10']:.3f} ms")
    del w, xg
    return ok


def replay_10p_inputs(torch, sizes: list, c=MOE):
    """Row 10p's inputs: each layer's rows past kernel 9's bucket capacity
    (``over``, one array a layer) at phase 7's router sizes, and the three
    kernel-10 calls a layer of _fused_prefill_try's overflow pass (gate and
    up at K E N FF, down at K FF N E) on random codes from seed 10. Returns
    (m, capacity, over, calls)."""
    from ik_llama_cpp_tpu_torch.ops.moe import fused_capacity
    g_, e_, ff = c["G"], c["E"], c["FF"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    m = int(np.sum(sizes[0]))
    r = fused_capacity(m, g_)
    over = [np.maximum(np.asarray(gs) - r, 0) for gs in sizes]
    calls = []
    for k, n in ((e_, ff), (e_, ff), (ff, e_)):
        w = torch.randint(-127, 128, (g_, n, k), generator=gen, device="cuda",
                          dtype=torch.int8).transpose(1, 2)
        sw = torch.rand((g_, k // 256, n), generator=gen, device="cuda") * 2e-3 + 1e-5
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        xs = torch.rand((m, k // 256), generator=gen, device="cuda") * 1e-2 + 1e-4
        calls.append((xq, xs, w, sw))
    return m, r, over, calls


def time_10p_layers(torch, timer, over: list, calls: list) -> float:
    """ms of every layer's three kernel-10 calls of row 10p, each timed
    alone (a clean L2 flush each), summed."""
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    kern = 0.0
    for o in over:
        gs = torch.from_numpy(o.astype(np.int32)).cuda()
        for xq, xs, w, sw in calls:
            kern += timer(lambda: MQ.ragged_qmatmul_i8(xq, xs.t(), w, sw, gs), 5)
    return kern


def phase_replay_10p(torch, timer, results, sizes: list, chunk_ms: dict, c=MOE) -> bool:
    """Row 10p of phase 3, after phase 7: kernel 10 at the overflow of
    phase 7's router (replay_10p_inputs), layer 0's gate call against its
    plain version (bits and a repeat), the library call and its bound, then
    every layer's three calls timed alone, summed beside the profiled
    chunk's kernel-10 time."""
    m, r, over, calls = replay_10p_inputs(torch, sizes, c)
    xq, xs, w, sw = calls[0]
    log(f"[3] 10p: kernel 10 at the overflow of phase 7's router (layer 0 of {len(sizes)}): "
        f"{int(over[0].sum())} of {m} rows past capacity {r}, "
        f"{int((over[0] > 0).sum())} experts with rows")
    xb = (xq.float() * torch.repeat_interleave(xs, 256, dim=1)).to(torch.bfloat16)
    wg = k_major((w.float() * torch.repeat_interleave(sw, 256, dim=1)).to(torch.bfloat16))
    ok = ragged_i8_case(torch, timer, results, xq, xs, w, sw, xb, wg, over[0],
                        f"M={m} K={c['E']} N={c['FF']} phase-7 router overflow, layer 0")
    del xb, wg
    kern = time_10p_layers(torch, timer, over, calls)
    log(f"[3] 10p: the {len(sizes)} layers' {3 * len(sizes)} calls timed alone (clean flush "
        f"each): kernel 10 {kern:.3f} ms; the profiled chunk's kernel 10 "
        f"{chunk_ms['10']:.3f} ms")
    del calls
    return ok


def router_sizes(torch, rt, ids, fn: str, pos: int) -> list:
    """The group sizes that the function ``fn`` of ops/moe.py is given (its
    argument ``pos``) in one prefill chunk of ``ids``, one list a call (a
    layer), each read back after its call (a chunk of its own, not timed):
    ``ragged_qmatmul``, 3, for kernel 14; ``_fused_prefill_try``, 1, for
    kernel 9's buckets and its kernel-10 overflow pass."""
    from ik_llama_cpp_tpu_torch.ops import moe
    seen, real = [], getattr(moe, fn)

    def spy(*a, **kw):
        seen.append(a[pos].tolist())
        return real(*a, **kw)

    setattr(moe, fn, spy)
    try:
        rt.eval_tokens(ids, rt.new_cache(1, PREFILL + 8), 0)
    finally:
        setattr(moe, fn, real)
    torch.cuda.synchronize()
    return seen


def phase_replay_14p(torch, timer, results, sizes: list, chunk_ms: dict, c=Q2MOE) -> bool:
    """Row 14p of phase 3, after phase 12: kernel 14 at the group sizes
    phase 12's router gave its prefill chunk, on random codes from a seed at
    that shape: layer 0's call against its plain version and the library
    call, then every layer's call timed alone, summed beside the profiled
    chunk's kernel-14 time (the model's warm L2 and back-to-back launches
    against the clean flush of each timed call here). Kernel 10, which
    takes the same sizes for the gate and up experts, the same way, beside
    its time at sizes that fill every expert."""
    from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
    from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ
    gen = torch.Generator(device="cuda").manual_seed(12)
    k, n, g_ = c["FF"], c["E"], c["G"]
    m = PREFILL * c["TOPK"]
    codes = torch.randint(-8, 9, (g_, n, k), generator=gen, device="cuda",
                          dtype=torch.int8).transpose(1, 2)
    sc = ((torch.rand((g_, k // 32, n), generator=gen, device="cuda") + 0.5)
          * (0.3 / 8 / k ** 0.5)).to(torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wg = k_major(MD.dequant_experts(codes, sc, 32))
    log(f"[3] 14p: kernel 14 at the group sizes of phase 12's router (layer 0 of "
        f"{len(sizes)}), M={m} K={k} N={n} G={g_}")
    ok = ragged_case(torch, timer, results, x, codes, sc, wg, np.asarray(sizes[0]),
                     "phase-12 router, layer 0")
    kern = lib = 0.0
    for gs in sizes:
        gsz = torch.tensor(gs, dtype=torch.int32, device="cuda")
        kern += timer(lambda: MQ.ragged_qmatmul(x, codes, sc, gsz, group=32), 5)
        lib += timer(lambda: grouped_library(x, wg, gsz), 5)
    log(f"[3] 14p: the {len(sizes)} layers' calls timed alone (clean flush each): kernel 14 "
        f"{kern:.3f} ms, library {lib:.3f} ms; the profiled chunk's kernel 14 "
        f"{chunk_ms['14']:.3f} ms")
    del codes, wg
    k, n = c["E"], c["FF"]
    w = torch.randint(-127, 128, (g_, n, k), generator=gen, device="cuda",
                      dtype=torch.int8).transpose(1, 2)
    sw = torch.rand((g_, k // 256, n), generator=gen, device="cuda") * 1e-3
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    xst = (torch.rand((m, k // 256), generator=gen, device="cuda") * 1e-2 + 1e-4).t()
    full = np.random.default_rng(12).multinomial(m, np.full(g_, 1.0 / g_))
    t10 = [timer(lambda: MQ.ragged_qmatmul_i8(xq, xst, w, sw, gsz), 5)
           for gsz in (torch.tensor(gs, dtype=torch.int32, device="cuda")
                       for gs in [*sizes, full])]
    log(f"[3] kernel 10 (gate and up, K={k} N={n} G={g_}) at the same sizes: the {len(sizes)} "
        f"layers' calls {sum(t10[:-1]):.3f} ms, twice that a chunk {2 * sum(t10[:-1]):.3f} ms "
        f"(the profiled chunk's kernel 10 {chunk_ms['10']:.3f} ms); a call at random sizes "
        f"(all {g_} experts live) {t10[-1]:.4f} ms, at the router's {sum(t10[:-1]) / len(sizes):.4f}")
    del w
    return ok


def phase_q2moe(torch, gguf: Path, launches: dict, phases: set, c=Q2MOE,
                replay: dict | None = None) -> bool:
    """Phase 12 (Qwen1.5-MoE-A2.7B at full width: mixed-format experts, a
    shared expert, attention biases) and phase 13a (its parity at depth 2)
    on one loaded model. ``replay`` gets phase 12's router group sizes of
    kernel 14 and the chunk's kernel-14 ms (row 14p)."""
    from ik_llama_cpp_tpu_torch.ops.moe import QuantExpertWeights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    nl, v = c["L"], c["V"]
    t_phase = t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), nl)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    blk = rt.params["blocks"][0]
    ex = blk["experts"]
    forms = isinstance(ex, QuantExpertWeights) and (
        (ex.gate_group, ex.up_group, ex.down_group, ex.gate_s.dtype, ex.up_s.dtype,
         ex.down_s.dtype) == (256, 256, 32, torch.float32, torch.float32, torch.bfloat16)
        and tuple(ex.gate_s.shape) == (c["G"], c["E"] // 256, c["FF"])
        and tuple(ex.down_s.shape) == (c["G"], c["FF"] // 32, c["E"]))
    shared = {n: type(blk[n]).__name__ for n in ("ffn_gate_shexp", "ffn_up_shexp",
                                                 "ffn_down_shexp", "ffn_gate_inp_shexp")}
    log(f"[12] loaded {rt.cfg.arch} L{nl} E{c['E']} H{c['H']} KV{c['HKV']} D{c['D']} experts "
        f"{c['G']} top-{c['TOPK']} FF{c['FF']} shared FF{c['FFS']} V{v} in {load_s:.1f} s; "
        f"gate/up experts {tuple(ex.gate.shape)} group {ex.gate_group} scales "
        f"{tuple(ex.gate_s.shape)} {ex.gate_s.dtype}, down experts {tuple(ex.down.shape)} "
        f"group {ex.down_group} scales {tuple(ex.down_s.shape)} {ex.down_s.dtype}: as "
        f"expected {forms}; linears {_linear_kinds(rt)}, shared expert {shared}, q/k/v "
        f"unfused (biases): {'wq' in blk and 'attn_q_bias' in blk}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = forms and "wq" in blk
    if 12 in phases:
        per = 7 * nl + 1        # q, k, v, o, the shared expert's three, and the head
        step = {"qmatmul_i8": per, "flash_attention_decode": nl,
                "moe_decode_gate_up": nl, "moe_decode_down": nl}
        chunk = {"qmatmul_i8": per, "flash_attention": nl,
                 "ragged_qmatmul_i8": 2 * nl, "ragged_qmatmul": nl, "ragged_qmatmul_wgmma": nl}
        good, counts, ids, toks, kv, n_past = moe_run(torch, rt, c, 12, "12", step, chunk, load_s)
        ok &= good
        launches.update({k: counts[k] for k in ("moe_decode_gate_up", "moe_decode_down",
                                                "ragged_qmatmul")})
        prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="12")
        k13, step_ms = kernel_ms(prof, "down_planar_kernel"), sum(prof.values())
        log(f"[12] kernel 13 (moe_decode_down, down_planar_kernel): {k13:.3f} ms a decode "
            f"step of {step_ms:.3f} ms of kernels ({100 * k13 / step_ms:.1f}%), "
            f"{counts['moe_decode_down'] / DECODE:g} launches a token")
        log(f"[12] decode step: kernel A {a_ms(prof)}; {c_ms(prof)}")
        del kv
        kv = rt.new_cache(1, PREFILL + 8)
        prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                              f"one {PREFILL}-token prefill chunk", "chunk", "12")
        log(f"[12] prefill chunk: kernel A {a_ms(prof)}")
        k14 = kernel_ms(prof, "ragged_wgmma_kernel", "ragged_kernel<")
        log(f"[12] prefill chunk: kernel 14 (ragged_qmatmul) {k14:.3f} ms, "
            f"{100 * k14 / sum(prof.values()):.1f}% of the chunk's {sum(prof.values()):.3f} ms "
            f"of kernels, {counts['ragged_qmatmul']} launches "
            f"({counts['ragged_qmatmul_wgmma']} of the wgmma form)")
        del kv
        sizes = router_sizes(torch, rt, ids, "ragged_qmatmul", 3)
        per = np.asarray(sizes)
        log(f"[12] kernel 14's group sizes from the router, {len(sizes)} calls of "
            f"{int(per[0].sum())} rows over {per.shape[1]} experts: experts with rows "
            f"{int((per > 0).sum(1).min())}-{int((per > 0).sum(1).max())} a call, rows an "
            f"expert mean {per.mean():.1f}, max {int(per.max())}; layer 0 {sizes[0]}")
        if replay is not None:
            replay.update(sizes=sizes, chunk_ms={"14": k14, "10": kernel_ms(
                prof, "ragged_i8_wgmma_kernel")})
        log(f"[12] mixed-format MoE end to end: {time.perf_counter() - t_phase:.1f} s")
    if 13 in phases:
        t0 = time.perf_counter()
        depth2(torch, rt)
        ids = [int(x) for x in np.random.default_rng(13).integers(3, v, 128)]
        _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
        good, text = parity_verdict(lk, lp)
        log(f"[13a] Qwen1.5-MoE-A2.7B shape (gate/up supergroup, down planar), depth 2, kernel "
            f"path vs plain path: {text}: {'ok' if good else 'FAIL'}; "
            f"{time.perf_counter() - t0:.1f} s")
        ok &= good
    del rt
    torch.cuda.empty_cache()
    return ok


def phase_planar_moe_parity(torch, gguf: Path, c=MOE) -> bool:
    """Phase 13b: the Qwen3-30B-A3B shape loaded with the int8 path off, so
    that all three expert projections stay planar (kernels 12 and 13 every
    decode step, kernel 14 three times a prefill chunk and layer), at depth 2."""
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    weights.set_i8_mxu(False)
    try:
        rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), 2)
    finally:
        weights.set_i8_mxu(None)
    ex = rt.params["blocks"][0]["experts"]
    groups = (ex.gate_group, ex.up_group, ex.down_group)
    ids = [int(x) for x in np.random.default_rng(15).integers(3, c["V"], 128)]
    reset_counts()
    _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
    counts = read_counts()
    good, text = parity_verdict(lk, lp)
    want = {"moe_decode_gate_up": 2 * 16, "moe_decode_down": 2 * 16, "ragged_qmatmul": 3 * 2,
            "ragged_qmatmul_wgmma": 3 * 2, "qmatmul": (2 * 2 + 1) * 17, "qmatmul_wgmma": 2 * 2 + 1, "flash_attention": 2,
            "flash_attention_decode": 2 * 16}
    got = {k: n for k, n in counts.items() if n}
    good &= groups == (32, 32, 32) and got == want
    log(f"[13b] Qwen3-30B-A3B shape with the int8 path off (expert groups {groups}, linears "
        f"{_linear_kinds(rt)}), depth 2, kernel path vs plain path: {text}; launches {got}, "
        f"expected {want}: {'ok' if good else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    del rt
    torch.cuda.empty_cache()
    return good


def phase_perf_dequant(torch, launches: dict) -> bool:
    """Phase 15: the microbenchmark tool through its entry point."""
    from ik_llama_cpp_tpu_torch.tools import perf_dequant
    reset_counts()
    res = perf_dequant.main(["--reps", "10"])
    counts = read_counts()
    launches["qmatmul_pair"] = counts["qmatmul_pair"]
    ok = (set(res) == {"int8-f32s", "int8-bf16s", "int16-pair", "torch-bf16"}
          and all(us > 0 and np.isfinite(gbs) for us, gbs in res.values())
          and counts["qmatmul_pair"] > 0 and counts["qmatmul"] > 0)
    log(f"[15] tools/perf_dequant: {len(res)} variants timed; launches kernel 16 "
        f"{counts['qmatmul_pair']}, kernel D {counts['qmatmul']}: {'ok' if ok else 'FAIL'}")
    return ok


SERVER_SLOTS = 4


def server_requests() -> list:
    """Phase 16's six requests: (name, Server method, body). Prompts of
    about 20 to 600 tokens from seed 16; three greedy requests (one with a
    stop string, one streamed), three sampled at temp 0.8, top_k 40 with
    fixed seeds (one a chat through the built-in llama-3 template)."""
    rng = np.random.default_rng(16)
    text = lambda n: smoke_text(rng, n)
    greedy = dict(temperature=0.0, return_tokens=True)
    sampled = dict(temperature=0.8, top_k=40, top_p=1.0, min_p=0.0)
    return [
        ("greedy 600", "completion", dict(prompt=text(540), n_predict=48, **greedy)),
        ("greedy stop", "completion", dict(prompt=text(36), n_predict=40, stop=["x"],
                                           **greedy)),
        ("greedy stream", "completion_stream", dict(prompt=text(120), n_predict=56,
                                                    stream=True, **greedy)),
        ("sampled chat", "oai_chat", dict(messages=[
            {"role": "system", "content": text(12)},
            {"role": "user", "content": text(40)}], max_tokens=32, seed=1, **sampled)),
        ("sampled 300", "oai_completions", dict(prompt=text(270), max_tokens=64, seed=2,
                                                **sampled)),
        ("sampled 20", "completion", dict(prompt=text(18), n_predict=40, seed=3, **sampled)),
    ]


def serve_all(srv, reqs) -> dict:
    """Every request from a thread of its own, all at once; {name: (result
    or the stream's events, error text)}."""
    import threading
    out = {}

    def run(name, method, body):
        try:
            res = getattr(srv, method)(body)
            out[name] = (list(res) if method.endswith("_stream") else res, None)
        except Exception as e:          # noqa: BLE001 - reported as a failed request
            out[name] = (None, f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def greedy_ids(method: str, res) -> list:
    """The generated ids of a greedy request (``return_tokens``)."""
    return res[-1]["data"]["tokens"] if method == "completion_stream" else res["tokens"]


def replay_verdict(torch, rt, prompt: list, gen: list, step_by_step: bool = False):
    """Phase 16's one-history parity: prompt + generated ids through
    Runtime.eval_tokens at B = 1 on the kernel path and on the plain path.
    The logits of every generation step agree within 5% of the largest
    (parity_verdict), and every token the engine emitted is the kernel
    replay's argmax, or its runner-up within 1% of the largest logit of
    the top 2 (the engine ran these rows at B = 4). ``step_by_step``
    replays as the engine ran them: the prompt in chunks, then each
    generated id a one-token step (a recurrent model's chunk rounds its
    bf16 residual stream at other points than its steps, enough to move a
    near-tied routing pick)."""
    ids = prompt + gen[:-1]
    cap = len(ids) + 16

    def replay():
        if not step_by_step:
            return rt.eval_tokens(ids, rt.new_cache(1, cap), 0, all_logits=True)[0][len(prompt) - 1:]
        lg, kv, n = rt.eval_tokens(prompt, rt.new_cache(1, cap), 0)
        return forced_logits(torch, rt, kv, n, lg[-1], gen[:-1])

    lk = replay()
    with plain_path():
        lp = replay()
    ok, text = parity_verdict(lk, lp)
    top2 = lk.topk(2, dim=1)
    bad = []
    for i, tok in enumerate(gen):
        best, second = int(top2.indices[i, 0]), int(top2.indices[i, 1])
        gap = float(top2.values[i, 0] - top2.values[i, 1])
        if tok != best and not (tok == second and gap <= 1e-2 * float(top2.values[i, 0].abs())):
            bad.append((i, tok, best, round(gap, 4)))
    return ok and not bad, text + (f"; emitted tokens off the replay's top: {bad}" if bad
                                   else f"; all {len(gen)} emitted tokens are the replay's picks")


def span_cost(torch, rt, capacity: int = 2048, bucket: int = 512) -> str:
    """What a prefill round of slots 0 and 2 costs at the server's default
    capacity, on a cache of 4 rows: the engine's one forward over the span
    of rows 0-2 (row 1 writes junk), beside one forward over two adjacent
    rows, a forward for each of the two slots, and the gather of the two
    rows and their scatter back that a copy would add (ms by CUDA events,
    median of 3 after a warm call)."""
    from ik_llama_cpp_tpu_torch.models import llama as llama_mod
    from ik_llama_cpp_tpu_torch.server.engine import _cache_tensors, cache_rows
    kv = rt.new_cache(4, capacity)
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, V, (3, bucket), dtype=np.int64)).to(rt.device)
    fwd = lambda t, lo, n: llama_mod.forward(rt.params, rt.cfg, t, cache_rows(kv, lo, n),
                                             [0] * n)
    sel = torch.tensor([0, 2], device=rt.device)

    def copy_rows():
        for t in _cache_tensors(kv):
            t.index_copy_(1, sel, t.index_select(1, sel))

    def ms(fn):
        fn()
        ts = []
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    two = ms(lambda: fwd(toks[:2], 0, 2))
    span = ms(lambda: fwd(toks, 0, 3))
    apart = ms(lambda: (fwd(toks[:1], 0, 1), fwd(toks[2:], 2, 1)))
    gather = ms(copy_rows)
    row = sum(t[:, 0].numel() * t.element_size() for t in _cache_tensors(kv))
    n_rows = kv.capacity
    del kv
    torch.cuda.empty_cache()
    return (f"prefill of slots 0 and 2 at bucket {bucket}, {n_rows} cache rows "
            f"({row / 2**20:.0f} MiB a slot): span of rows 0-2 {span:.2f} ms, two adjacent "
            f"rows {two:.2f} ms, a forward a slot {apart:.2f} ms; a gather and scatter "
            f"back of the two rows {gather:.2f} ms and {2 * row / 2**20:.0f} MiB")


def phase_server(torch, gguf: Path, spent: dict | None = None, phases=frozenset({16}),
                 card: str = "") -> bool:
    """Phase 16: the text-serving path at the full width of phase 4 (L32):
    a BatchEngine of SERVER_SLOTS slots over one bf16 cache, driven through
    the Server's request methods (no HTTP) with six text requests at once,
    every kernel launch of the run counted; then each greedy request's
    one-history parity, then 16b. Phase 25 follows on the same loaded
    model (alone when 16 is not asked for)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    from ik_llama_cpp_tpu_torch.server.app import Server
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    t_phase = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    if 16 not in phases:
        return phase_multimodal_timed(torch, rt, spent, card)
    eng = BatchEngine(rt, n_slots=SERVER_SLOTS, capacity=1024)
    srv = Server(eng, model_name="smoke8b", template="llama3")
    reqs = server_requests()
    eng.start()
    srv.completion(dict(prompt="warm up", n_predict=4, temperature=0.0))
    sync(torch)
    log(f"[16] loaded L{NL} and served one warm-up request in "
        f"{time.perf_counter() - t_phase:.1f} s; {SERVER_SLOTS} slots, capacity 1024")
    steps0, fwd0, gen0 = eng.n_decode_steps, eng.n_prefill_forwards, eng.n_tokens_predicted
    prompt0 = eng.n_prompt_tokens_processed
    reset_counts()
    t0 = time.perf_counter()
    out = serve_all(srv, reqs)
    sync(torch)
    secs = time.perf_counter() - t0
    counts = read_counts()
    alive, failed = eng.alive, eng.n_failed
    eng.stop()
    steps, fwds = eng.n_decode_steps - steps0, eng.n_prefill_forwards - fwd0
    n_gen = eng.n_tokens_predicted - gen0
    n_prompt = eng.n_prompt_tokens_processed - prompt0
    ok = alive and failed == 0 and all(err is None for _, err in out.values())
    tok = rt.tokenizer
    for name, method, body in reqs:
        res, err = out[name]
        if err is not None:
            log(f"[16] {name}: FAILED: {err}")
            continue
        if method == "completion_stream":
            text = "".join(ev["data"]["content"] for ev in res)
            good = res[-1]["data"]["stop"] and res[-1]["data"]["tokens_predicted"] > 0
        elif method == "oai_chat":
            text = res["choices"][0]["message"]["content"] or ""
            good = (res["choices"][0]["message"]["role"] == "assistant"
                    and res["usage"]["completion_tokens"] > 0)
        elif method == "oai_completions":
            text = res["choices"][0]["text"]
            good = res["usage"]["completion_tokens"] > 0
        else:
            text = res["content"]
            good = res["tokens_predicted"] > 0
        if body.get("stop"):
            good = good and not any(st in text for st in body["stop"])
        if body.get("return_tokens"):
            gen = greedy_ids(method, res)
            good = good and all(0 <= t < V for t in gen)
        ok &= good
        log(f"[16] {name} ({method}): {len(text)} chars {text[:60]!r}: "
            f"{'ok' if good else 'FAIL'}")
    per = 4 * NL + 1
    want_a = per * (steps + fwds)
    ab = (counts["qmatmul_i8"] > 0 and counts["flash_attention"] > 0
          and counts["flash_attention_decode"] > 0)
    exact = (counts["qmatmul_i8"] == want_a
             and counts["flash_attention"] + counts["flash_attention_decode"]
             == NL * (steps + fwds)
             and counts["flash_attention_decode"] >= NL * steps)
    others = {k: v for k, v in counts.items()
              if v and k not in ("qmatmul_i8", "flash_attention", "flash_attention_decode")}
    ok &= ab and exact and not others
    log(f"[16] {len(reqs)} requests on {SERVER_SLOTS} slots: {n_prompt} prompt tokens, "
        f"{n_gen} generated tokens in {secs:.2f} s = {n_gen / secs:.2f} tok/s over all slots, "
        f"{len(reqs) / secs:.3f} requests/s; {steps} decode steps at B = {SERVER_SLOTS} "
        f"({eng.n_topk_steps} with the top-k readback in all), {fwds} prefill forwards; "
        f"failed requests {failed}, engine thread alive {alive}")
    log(f"[16] launches A {counts['qmatmul_i8']} (want {per} a forward = {want_a}), "
        f"B {counts['flash_attention']}, C {counts['flash_attention_decode']} "
        f"(B + C = {NL} a forward, C >= {NL} a decode step); a decode step at "
        f"B = {SERVER_SLOTS}: A {per}, C {NL}; other kernels {others}: "
        f"{'ok' if ab and exact and not others else 'FAIL'}")
    t1 = time.perf_counter()
    for name, method, body in reqs:
        res, err = out[name]
        if err is not None or not body.get("return_tokens"):
            continue
        good, text = replay_verdict(torch, rt, tok.encode(body["prompt"]),
                                    greedy_ids(method, res))
        ok &= good
        log(f"[16] {name} replay at B = 1, kernel path vs plain path: {text}: "
            f"{'ok' if good else 'FAIL'}")
    log(f"[16] parity {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    log(f"[16] {span_cost(torch, rt)} ({time.perf_counter() - t1:.1f} s)")
    log(f"[16] text-serving path: {time.perf_counter() - t_phase:.1f} s in all")
    del eng, srv
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    try:
        ok &= phase_server_extras(torch, rt)
    except Exception as e:              # noqa: BLE001 - reported as the phase's failure
        import traceback
        traceback.print_exc()
        log(f"[16b] FAILED: {type(e).__name__}: {e}")
        ok = False
    if spent is not None:
        spent["16b"] = time.perf_counter() - t1
    if 25 in phases:
        ok &= phase_multimodal_timed(torch, rt, spent, card)
    del rt
    torch.cuda.empty_cache()
    return bool(ok)


def phase_multimodal_timed(torch, rt, spent: dict | None, card: str) -> bool:
    """Phase 25 on a loaded model, its seconds kept apart in ``spent``; a
    failure is reported as the phase's."""
    t0 = time.perf_counter()
    try:
        ok = phase_multimodal(torch, rt, card)
    except Exception as e:              # noqa: BLE001 - reported as the phase's failure
        import traceback
        traceback.print_exc()
        log(f"[25] FAILED: {type(e).__name__}: {e}")
        ok = False
    if spent is not None:
        spent["25"] = time.perf_counter() - t0
    return ok


SLOT_WORDS = 900           # about 1,000 tokens of smoke_text
EXTRAS_TOOLS = [{"type": "function", "function": {
    "name": "weather", "parameters": {"type": "object", "properties": {
        "unit": {"enum": ["celsius", "fahrenheit"]}}, "required": ["unit"],
        "additionalProperties": False}}}]


def _row_bits(torch, kv, n: int) -> list:
    """Slot 0's rows [0, n) of every cache tensor, as integers (bf16 as its
    16-bit words), cloned."""
    from ik_llama_cpp_tpu_torch.server.engine import _cache_tensors
    out = []
    for t in _cache_tensors(kv):
        r = t[:, 0, :n]
        out.append((r.view(torch.int16) if r.dtype == torch.bfloat16 else
                    r.view(torch.int32) if r.dtype == torch.float32 else r).clone())
    return out


def slot_state_round(torch, rt, tag: str, save_dir: Path, gb: dict) -> bool:
    """16b's slot state on a one-slot engine over ``rt``'s cache type: a
    ~1,000-token prompt served and saved; an extending request served (the
    uninterrupted slot's tokens); the slot erased and overwritten by an
    unrelated request; the state restored (rows bit for bit) and the
    extending request served again (the restored tokens counted as cached,
    the same greedy tokens). The last request's launches are counted."""
    from ik_llama_cpp_tpu_torch.server.app import Server
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    rng = np.random.default_rng(161)
    eng = BatchEngine(rt, n_slots=1, capacity=2048)
    srv = Server(eng, model_name="smoke8b", template="llama3")
    srv.slot_save_path = str(save_dir)
    tok = rt.tokenizer
    eng.start()
    try:
        greedy = dict(temperature=0.0, return_tokens=True)
        p1 = tok.encode(smoke_text(rng, SLOT_WORDS))
        r1 = srv.completion(dict(prompt=p1, n_predict=8, **greedy))
        saved = srv.slot_action(0, "save", {"filename": f"{tag}.bin"})
        n = saved["n_saved"]
        rows = _row_bits(torch, eng.kv, n)
        # ~65 new tokens: a prefill chunk above DECODE_MAX_T, so the prefill
        # attention (B, or 6 over q8) reads the restored rows, then the decode
        ext = p1 + r1["tokens"] + tok.encode(smoke_text(rng, 60), add_bos=False)
        want = srv.completion(dict(prompt=ext, n_predict=16, **greedy))["tokens"]
        n_before = len(eng.slots[0].cache_tokens)     # the slot is idle
        erased = srv.slot_action(0, "erase")
        srv.completion(dict(prompt=smoke_text(rng, 300), n_predict=8, **greedy))
        restored = srv.slot_action(0, "restore", {"filename": f"{tag}.bin"})
        back = _row_bits(torch, eng.kv, n)
        same_rows = all(torch.equal(a, b) for a, b in zip(rows, back))
        cached0 = eng.n_prompt_tokens_cached
        reset_counts()
        got = srv.completion(dict(prompt=ext, n_predict=16, **greedy))["tokens"]
        sync(torch)
        counts = read_counts()
        cached = eng.n_prompt_tokens_cached - cached0
        alive, failed = eng.alive, eng.n_failed
    finally:
        eng.stop()
    size = (save_dir / f"{tag}.bin").stat().st_size
    save_ms, restore_ms = saved["timings"]["save_ms"], restored["timings"]["restore_ms"]
    gb[tag] = (size, save_ms, restore_ms)
    ok = (same_rows and got == want and cached == n == restored["n_restored"]
          and erased["n_erased"] == n_before > 0 and alive and failed == 0)
    # the prefill and decode attention that read the restored rows: B and
    # C over bf16, kernels 6 and 5 over q8
    pre, dec = (("flash_attention_q8", "flash_attention_decode_q8") if rt.kv_quant
                else ("flash_attention", "flash_attention_decode"))
    ok &= counts[pre] == NL and counts[dec] == 15 * NL
    kinds = {k: v for k, v in counts.items() if v}
    log(f"[16b] {tag} cache: saved {n} tokens of a {len(p1)}-token prompt + 8 generated, "
        f"{size / 2**20:.1f} MiB ({size / max(n, 1) / 1024:.1f} KiB a token); save "
        f"{save_ms:.1f} ms = {size / save_ms / 1e6:.2f} GB/s, restore {restore_ms:.1f} ms = "
        f"{size / restore_ms / 1e6:.2f} GB/s (file to card rows, warm page cache); restored "
        f"rows bit for bit {same_rows}; the extending request ({len(ext)} tokens) counted "
        f"{cached} cached (want {n}), its 16 greedy tokens equal the uninterrupted slot's "
        f"{got == want}; its launches {kinds}: {'ok' if ok else 'FAIL'}")
    return ok


def _first_word(text: str, start: int = 1) -> str | None:
    import re
    m = re.compile(r"[A-Za-z]{3,}").search(text, start)
    return m.group(0) if m else None


def phase_server_extras(torch, rt) -> bool:
    """Phase 16b on phase 16's loaded L32 model: slot state over a bf16 and
    a q8 cache, then every request option of the server-extras slice
    through the Server's request methods, each gated on the model's own
    unconstrained greedy run (random weights rate nothing)."""
    import re
    from ik_llama_cpp_tpu_torch.runtime.allowlist import script_of
    from ik_llama_cpp_tpu_torch.server.app import Server
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    t_phase = time.perf_counter()
    save_dir = ROOT / "build" / "slots"
    save_dir.mkdir(parents=True, exist_ok=True)
    gb = {}
    ok = slot_state_round(torch, rt, "bf16", save_dir, gb)
    ok &= slot_state_round(torch, replace(rt, kv_quant="q8"), "q8", save_dir, gb)
    log(f"[16b] slot state over both caches: {time.perf_counter() - t_phase:.1f} s")
    eng = BatchEngine(rt, n_slots=1, capacity=1024)
    srv = Server(eng, model_name="smoke8b", template="llama3")
    tok = rt.tokenizer
    rng = np.random.default_rng(162)
    prompt = smoke_text(rng, 40)
    greedy = dict(temperature=0.0, return_tokens=True)
    times = {}

    def run(name, method, body):
        t0 = time.perf_counter()
        out = getattr(srv, method)(body)
        out = list(out) if method.endswith("_stream") else out
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    def gate(name, good, detail):
        nonlocal ok
        ok &= bool(good)
        log(f"[16b] {name} ({times.get(name, 0.0):.0f} ms): {detail}: "
            f"{'ok' if good else 'FAIL'}")

    eng.start()
    try:
        steps0, fwd0 = eng.n_decode_steps, eng.n_prefill_forwards
        reset_counts()
        free = run("free run", "completion", dict(prompt=prompt, n_predict=32, **greedy))
        sync(torch)
        counts = read_counts()
        steps, fwds = eng.n_decode_steps - steps0, eng.n_prefill_forwards - fwd0
        per = 4 * NL + 1
        good = (counts["qmatmul_i8"] == per * (steps + fwds)
                and counts["flash_attention"] + counts["flash_attention_decode"]
                == NL * (steps + fwds)
                and counts["flash_attention_decode"] >= NL * steps)
        gate("free run", good, f"{steps} decode steps, {fwds} prefill forwards: A "
             f"{counts['qmatmul_i8']} (A {per} and C {NL} a decode step: want "
             f"{per * (steps + fwds)}), B {counts['flash_attention']}, C "
             f"{counts['flash_attention_decode']}; text {free['content'][:60]!r}")
        text, toks = free["content"], free["tokens"]
        pieces = [tok.decode_bytes([t]).decode("utf-8", "replace") for t in toks]

        at = [len("".join(pieces[:i])) for i in range(len(pieces))]
        word = _first_word(text)
        n_rw = eng.n_rewinds
        banned = run("bans", "completion", dict(prompt=prompt, n_predict=32,
                                                banned_strings=[word], **greedy))
        pos = text.lower().find(word.lower())
        cut = max(a for a in at if a <= pos)      # the start of the token holding the match
        gate("bans", word.lower() not in banned["content"].lower() and eng.n_rewinds > n_rw
             and banned["content"][:cut] == text[:cut],
             f"banned {word!r} (char {pos} of the free run, in the token at char {cut}): "
             f"{eng.n_rewinds - n_rw} rewinds, the text before that token kept, "
             f"{banned['content'][:60]!r}")

        tag = word
        rb = run("reasoning budget", "completion", dict(
            prompt=prompt, n_predict=48, reasoning_budget=4, reasoning_budget_start_tag=tag,
            **greedy))
        k = next((i for i in range(len(rb["tokens"]))
                  if tag in tok.decode(rb["tokens"][:i + 1])), None)
        forced = tok.encode("\n</think>\n", add_bos=False)
        good = k is not None and rb["tokens"][k + 4:k + 4 + len(forced)] == forced
        gate("reasoning budget", good, f"start tag {tag!r} at token {k}, the forced "
             f"{len(forced)}-token end tag after 4 tokens")

        i = next((i for i in range(1, len(pieces) - 4)
                  if re.fullmatch(r" ?[A-Za-z]+", pieces[i]) and text.find(pieces[i]) == at[i]),
                 None)
        trig = pieces[i] if i is not None else word
        # after the trigger, letters a-j and spaces only: a class the free
        # run leaves, and one a greedy pick meets within the grammar
        # sampler's 2,048 tries on a 32,000-piece vocabulary
        lazy = run("lazy grammar", "completion", dict(
            prompt=prompt, n_predict=24, grammar=f"root ::= {json.dumps(trig)} [a-j ]+\n",
            grammar_lazy=True, grammar_triggers=[trig], **greedy))
        lt = lazy["content"]
        after = lt[lt.find(trig) + len(trig):] if trig in lt else ""
        free_after = text[text.find(trig) + len(trig):]
        gate("lazy grammar", i is not None and lt.find(trig) == text.find(trig)
             and re.fullmatch("[a-j ]*[a-j][a-j ]*", after) is not None
             and lt[:lt.find(trig)] == text[:text.find(trig)],
             f"trigger {trig!r}, after it {after[:30]!r} (the free run: {free_after[:30]!r})")

        call = run("forced tool call", "oai_chat", dict(
            messages=[{"role": "user", "content": prompt}], tools=EXTRAS_TOOLS,
            tool_choice={"type": "function", "function": {"name": "weather"}},
            max_tokens=96, temperature=0.0))
        calls = call["choices"][0]["message"].get("tool_calls") or []
        args = json.loads(calls[0]["function"]["arguments"]) if calls else {}
        gate("forced tool call", len(calls) == 1 and calls[0]["function"]["name"] == "weather"
             and set(args) == {"unit"} and args["unit"] in ("celsius", "fahrenheit"),
             f"{calls[0]['function'] if calls else call['choices'][0]['message']}")

        allow = run("allowlist", "completion", dict(
            prompt=prompt, n_predict=24, allowlist_unicode_rules=[["common"]], **greedy))
        own = [tok.decode_bytes([t]).decode("utf-8", "replace") for t in allow["tokens"]]
        latin = [p for p in own if any(script_of(ord(c)) == "latin" for c in p)]
        in_text = sum(script_of(ord(c)) == "latin" for c in allow["content"])
        gate("allowlist", not latin and allow["tokens"],
             f"rules [common] ban every other script: Latin code points in the emitted "
             f"tokens' pieces "
             f"{len(latin)}, in the text {in_text} (bytes joined across tokens are outside "
             f"a token's piece); text {allow['content'][:40]!r}")

        phrase = next(w for w in WORDS if w not in text and len(w) > 3)
        elb = run("expiring bias", "completion", dict(
            prompt=prompt, n_predict=24, expiring_logit_bias=f'(12 : "{phrase}" : 40.0)\n',
            **greedy))
        within = tok.decode(elb["tokens"][:12])
        gate("expiring bias", phrase in within, f"+40 on {phrase!r} for 12 tokens: "
             f"{within[:60]!r}")

        probs = run("post-sampling probs", "completion", dict(
            prompt=prompt, n_predict=8, n_probs=3, post_sampling_probs=True, **greedy))
        cp = probs["completion_probabilities"]
        good = len(cp) == len(probs["tokens"]) and all(
            sum(x["prob"] for x in p["probs"]) <= 1 + 1e-6
            and p["probs"][0]["tok_str"] == tok.decode([t])
            for p, t in zip(cp, probs["tokens"]))
        gate("post-sampling probs", good, f"{len(cp)} steps, top entries "
             f"{[p['probs'][0]['prob'] for p in cp][:4]}")

        body = {"system": "Answer briefly.", "max_tokens": 16, "temperature": 0.0,
                "messages": [{"role": "user", "content": prompt}]}
        msg = run("anthropic", "anthropic_messages", dict(body))
        n_in = srv.anthropic_count_tokens(
            {"system": body["system"], "messages": body["messages"]})["input_tokens"]
        rendered = srv._chat_prompt([{"role": "system", "content": body["system"]}]
                                    + body["messages"])
        events = run("anthropic stream", "anthropic_messages_stream", {**body, "stream": True})
        good = (msg["type"] == "message" and msg["role"] == "assistant"
                and msg["content"][0]["type"] == "text" and msg["usage"]["output_tokens"] > 0
                and msg["usage"]["input_tokens"] == n_in == len(tok.encode(rendered))
                and events[0]["event"] == "message_start"
                and events[-1]["event"] == "message_stop")
        gate("anthropic", good, f"stop_reason {msg['stop_reason']}, usage {msg['usage']}, "
             f"count_tokens {n_in}, {len(events)} stream events")
        alive, failed = eng.alive, eng.n_failed
    finally:
        eng.stop()
    ok &= alive and failed == 0
    log(f"[16b] engine alive {alive}, failed requests {failed}; request ms "
        + ", ".join(f"{k} {v:.0f}" for k, v in times.items()))
    log(f"[16b] server extras: {time.perf_counter() - t_phase:.1f} s in all")
    return bool(ok)


def _linear_kinds(rt) -> list:
    return sorted({type(v).__name__ for b in rt.params["blocks"] for v in b.values()
                   if hasattr(v, "forward")})


def _cache_bytes(kv) -> int:
    """Device bytes of a KVCache or MixedKVCache: every tensor field."""
    return sum(t.numel() * t.element_size() for t in vars(kv).values()
               if hasattr(t, "element_size"))


def phase_kvq(torch, gguf: Path, launches: dict) -> bool:
    """Phase 9: the full-width dense model over a quantized KV cache. The
    weights are loaded once; each configuration gets a new cache."""
    from ik_llama_cpp_tpu_torch.ops import flash_attention as FA
    from ik_llama_cpp_tpu_torch.runtime import kshift
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True, kv_quant="q8"), L9)
    torch.cuda.synchronize()
    log(f"[9] loaded L{L9} E{E} H{H} KV{HKV} FF{FF} V{V} with kv_quant='q8' in "
        f"{time.perf_counter() - t_phase:.1f} s; linears {_linear_kinds(rt)}")
    base_cfg = rt.cfg
    rng = np.random.default_rng(6)
    per = 4 * L9 + 1
    ok = True
    mixed = {"type": "q4", "first": "q8", "last": "q8"}
    runs = [("q8", "q8", False, DECODE), ("q4", "q4", False, DECODE),
            ("q6", "q6", False, DECODE), ("nl4", "nl4", False, DECODE),
            ("q8 + khad + vhad", "q8", True, 16), (f"dict {mixed}", mixed, False, 16),
            ("bf16 (for comparison)", False, False, DECODE)]
    kv_q8 = None
    for name, quant, had, n_dec in runs:
        rt.kv_quant = quant
        rt.cfg = replace(base_cfg, k_hadamard=had, v_hadamard=had)
        ids = [int(x) for x in rng.integers(3, V, PREFILL)]
        timed_run(torch, rt, ids, 4)                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids, n_dec)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_q8 = L9 if quant == "q8" else (2 if isinstance(quant, dict) else 0)
        want = dict.fromkeys(counts, 0)
        want["qmatmul_i8"] = per * (1 + n_dec)
        if quant:       # prefill: kernel 6 on q8 layers, dequantize + kernel B on the others
            want.update({"flash_attention_q8": n_q8, "flash_attention": L9 - n_q8,
                         "flash_attention_decode_q8": L9 * n_dec})
        else:
            want.update({"flash_attention": L9, "flash_attention_decode": L9 * n_dec})
        good = counts == want
        finite = bool(torch.isfinite(logits).all())
        in_range = bool(((toks >= 0) & (toks < V)).all())
        log(f"[9] {name}: prefill {PREFILL} tokens {pre_s * 1e3:.1f} ms = "
            f"{PREFILL / pre_s:.1f} tok/s; decode {n_dec} tokens at context {PREFILL}: "
            f"{dec_s * 1e3:.1f} ms = {n_dec / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB; "
            f"cache {type(kv).__name__} capacity {kv.capacity}: {_cache_bytes(kv)} bytes")
        log(f"[9] {name}: launches { {k: v for k, v in counts.items() if v} }; "
            f"as expected: {good}; logits finite: {finite}; tokens in vocab: {in_range}")
        if not good:
            log(f"    expected { {k: v for k, v in want.items() if v} }")
        ok &= good and finite and in_range
        if quant:
            for k in ("flash_attention_decode_q8", "flash_attention_q8"):
                launches[k] = launches.get(k, 0) + counts[k]
        # the profiled steps write rows past n_past + n_dec, which stay unused
        profile_decode(torch, rt, kv, n_past + n_dec + 1, toks[:, -1:],
                       steps=8 if name == "q8" else 2, tag=f"9 {name}",
                       top=12 if name == "q8" else 0)
        if name == "q8":
            kv_q8, n_q8_past, last_tok = kv, n_past + n_dec, toks[:, -1:]
        else:
            del kv
    ok &= kvq_long_context(torch, rt, base_cfg, rng)
    # K-shift on the q8 cache: drop 128 rows after the first 4, then decode on
    rt.kv_quant, rt.cfg = "q8", base_cfg
    if not kshift.can_shift(rt.cfg):
        fail("the dense llama configuration must be shiftable")
    kv_plain = copy.deepcopy(kv_q8)
    n_keep, n_discard, steps = 4, 128, 8
    before = FA.flash_attention_decode_q8.launches
    kv_q8, n1 = kshift.k_shift(kv_q8, rt.cfg, n_keep, n_discard, n_q8_past)
    lg = llama_step(torch, rt, last_tok, kv_q8, n1)
    tk, lk = greedy_from(torch, rt, kv_q8, n1 + 1, lg, steps)
    launched = FA.flash_attention_decode_q8.launches - before
    with plain_path():
        kv_plain, n2 = kshift.k_shift(kv_plain, rt.cfg, n_keep, n_discard, n_q8_past)
        lgp = llama_step(torch, rt, last_tok, kv_plain, n2)
        lp = forced_logits(torch, rt, kv_plain, n2 + 1, lgp, tk)
    err = float((lk[0] - lp[0]).abs().max())
    scale = float(lp[0].abs().max())
    _, text = parity_verdict(lk, lp)
    shift_ok = (n1 == n2 == n_q8_past - n_discard and launched == L9 * (steps + 1)
                and err <= 5e-2 * scale and bool(torch.isfinite(lk).all()))
    log(f"[9] k_shift(n_keep {n_keep}, n_discard {n_discard}) on the q8 cache: n_past "
        f"{n_q8_past} -> {n1}; {steps + 1} more decode steps, kernel 5 launched {launched} "
        f"times; against the same shift and the same tokens by the plain path: first-step "
        f"logits max_abs_err {err:.3e} (max |logit| {scale:.3f}, tol 5% of it: the gate at "
        f"depth {L9}); all steps: {text}: {'ok' if shift_ok else 'FAIL'}")
    ok &= shift_ok
    del rt, kv_q8, kv_plain
    torch.cuda.empty_cache()
    log(f"[9] quantized KV end to end: {time.perf_counter() - t_phase:.1f} s")
    return ok


LONG = 4000      # cached tokens of phase 9's long-context decode


def kvq_long_context(torch, rt, base_cfg, rng) -> bool:
    """Phase 9 at the context a quantized cache is for: a q8 cache and a
    bf16 one of capacity 4,096, filled with LONG - 1 tokens by the prefill
    chunks, then 8 decode steps profiled at ~LONG keys (after 2 warm ones):
    kernel 5's ms a step beside kernel C's, and their launches."""
    ids = [int(x) for x in rng.integers(3, V, LONG - 1)]
    ok, ms, fill_ms, fill_n, fill_s = True, {}, {}, {}, {}
    t_long = time.perf_counter()
    for name, quant, key, kname, pkey, pname in (
            ("q8", "q8", "flash_attention_decode_q8", "fa_decode_q_kernel<",
             "flash_attention_q8", "fa_q8_kernel<"),
            ("bf16", False, "flash_attention_decode", "fa_decode_kernel<",
             "flash_attention", "fa_prefill_kernel<")):
        rt.kv_quant, rt.cfg = quant, base_cfg
        kv = rt.new_cache(1, LONG)
        filled = {}

        def fill():
            filled["r"] = rt.eval_tokens(ids, kv, 0)
        reset_counts()
        t0 = time.perf_counter()
        prof = profile_window(torch, fill, 1, f"the {LONG - 1}-token fill", "fill",
                              f"9 {name} fill", top=6, host=False)
        fill_s[name] = time.perf_counter() - t0
        logits, kv, n_past = filled["r"]
        fill_ms[name], fill_n[name] = kernel_ms(prof, pname), read_counts()[pkey]
        tok = torch.argmax(logits[-1]).reshape(1, 1)
        reset_counts()
        prof = profile_decode(torch, rt, kv, n_past, tok, steps=8, tag=f"9 {name} at {LONG}",
                              top=6)
        n = read_counts()[key]
        ms[name] = kernel_ms(prof, kname)
        good = (n == L9 * 10 and kv.capacity == 4096 and bool(torch.isfinite(logits).all())
                and fill_n[name] > 0 and fill_n[name] % L9 == 0 and fill_ms[name] > 0)
        log(f"[9] {name} cache, capacity {kv.capacity}, {n_past} tokens prefilled: {key} "
            f"{ms[name]:.3f} ms a decode step at {n_past + 1}-{n_past + 8} keys, "
            f"{n} launches in 10 steps (expected {L9 * 10}): {'ok' if good else 'FAIL'}")
        ok &= good
        del kv
    log(f"[9] decode at {LONG} keys: kernel 5 {ms['q8']:.3f} ms a step over the q8 cache, "
        f"kernel C {ms['bf16']:.3f} ms over the bf16 one")
    log(f"[9] the {LONG - 1}-token fill: kernel 6 {fill_ms['q8']:.3f} ms over the q8 cache "
        f"({fill_n['q8']} launches), kernel B {fill_ms['bf16']:.3f} ms over the bf16 one "
        f"({fill_n['bf16']} launches)")
    log(f"[9] long context: {time.perf_counter() - t_long:.1f} s, of which the profiled fills "
        f"{fill_s['q8']:.1f} s (q8) and {fill_s['bf16']:.1f} s (bf16)")
    return ok


def llama_step(torch, rt, tok, kv, n_past):
    """One decode step of token ``tok`` (1, 1) at n_past: its logits (V,),
    through the model's own forward (the llama graph or the DeepSeek-2
    family's)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import FORWARDS
    return FORWARDS[rt.cfg.arch](rt.params, rt.cfg, tok, kv, n_past,
                                 logits_last_only=True)[0, -1]


def _differing(torch, a, b, n: int, layer: int | None = None):
    """Share of the first n rows' K and V code bytes that differ."""
    bad = tot = 0
    layers = range(len(a.layer_map)) if hasattr(a, "layer_map") else range(a.k.shape[0])
    for i in (layers if layer is None else [layer]):
        for f in ("k", "v"):
            x, y = getattr(a, f)[i][:, :n], getattr(b, f)[i][:, :n]
            bad += int((x != y).sum())
            tot += x.numel()
    return bad / tot


def phase_kvq_parity(torch, gguf: Path) -> bool:
    """Phase 10: at depth 2, for each codec (and q8 with the Hadamard
    rotation), the kernel path against the plain path on the card."""
    from ik_llama_cpp_tpu_torch.runtime import kshift
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True, kv_quant="q8"), 2)
    base_cfg = rt.cfg
    ids = [int(x) for x in np.random.default_rng(7).integers(3, V, 128)]
    ok = True
    for name, quant, had in (("q8", "q8", False), ("q4", "q4", False), ("q6", "q6", False),
                             ("nl4", "nl4", False), ("q8 + khad + vhad", "q8", True)):
        rt.kv_quant = quant
        rt.cfg = replace(base_cfg, k_hadamard=had, v_hadamard=had)
        tk, lk, lp, kvk, kvp, nk = forced_parity(torch, rt, ids, 16)
        good, text = parity_verdict(lk, lp)
        d0, d_all = _differing(torch, kvk, kvp, nk, 0), _differing(torch, kvk, kvp, nk)
        good = good and d0 <= 1e-2
        log(f"[10] {name}, depth 2, kernel path vs plain path: {text}; cache code bytes "
            f"that differ over {nk} rows: layer 0 {100 * d0:.3f}% (its inputs differ only "
            f"by the float32 summation order of kernel A: stray steps, gate 1%), both "
            f"layers {100 * d_all:.3f}% (layer 1 sees attention outputs that differ by "
            f"bf16 ulps): {'ok' if good else 'FAIL'}")
        ok &= good
        if name == "q8":        # K-shift on both caches, then on over one history
            kvk, n1 = kshift.k_shift(kvk, rt.cfg, 4, 32, nk)
            nxt = torch.argmax(lk[-1]).reshape(1, 1)
            lg = llama_step(torch, rt, nxt, kvk, n1)
            sk, slk = greedy_from(torch, rt, kvk, n1 + 1, lg, 8)
            with plain_path():
                kvp, n2 = kshift.k_shift(kvp, rt.cfg, 4, 32, nk)
                lg = llama_step(torch, rt, nxt, kvp, n2)
                slp = forced_logits(torch, rt, kvp, n2 + 1, lg, sk)
            good, text = parity_verdict(slk, slp)
            good = good and n1 == n2 == nk - 32
            log(f"[10] q8 after k_shift(n_keep 4, n_discard 32), n_past {nk} -> {n1}, 8 more "
                f"steps: {text}: {'ok' if good else 'FAIL'}")
            ok &= good
        del kvk, kvp
    del rt
    torch.cuda.empty_cache()
    log(f"[10] quantized-KV parity: {time.perf_counter() - t0:.1f} s")
    return ok


def phase_int4(torch, gguf: Path, launches: dict) -> bool:
    """Phase 11: 4-bit packed weights at full width, then parity at depth 2."""
    from ik_llama_cpp_tpu_torch.models import weights
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = time.perf_counter()
    weights.set_pack_int4(True)
    try:
        rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    finally:
        weights.set_pack_int4(False)
    torch.cuda.synchronize()
    kinds, head = _linear_kinds(rt), type(rt.params["output"]).__name__
    luts = {v.lut16 for b in rt.params["blocks"] for v in b.values() if hasattr(v, "lut16")}
    log(f"[11] loaded L{NL} with set_pack_int4(True) in {time.perf_counter() - t_phase:.1f} s: "
        f"block linears {kinds} (codebooks {luts}: Q4_0 codes are the dense [-8, 7] range), "
        f"head {head} (Q8_0 has 255 code values: not packable); device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok = kinds == ["QLinearI4"] and head == "QLinearI8"
    rng = np.random.default_rng(8)
    timed_run(torch, rt, [int(x) for x in rng.integers(3, V, PREFILL)], 4)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    reset_counts()
    logits, toks, kv, n_past, pre_s, dec_s = timed_run(torch, rt, ids)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches["qmatmul4"] = counts["qmatmul4"]
    launches["qmatmul4_wgmma"] = counts["qmatmul4_wgmma"]
    want = dict.fromkeys(counts, 0)
    want.update({"qmatmul4": 4 * NL * (1 + DECODE), "qmatmul4_wgmma": 4 * NL,
                 "qmatmul_i8": 1 + DECODE,
                 "flash_attention": NL, "flash_attention_decode": NL * DECODE})
    good = counts == want
    finite = bool(torch.isfinite(logits).all())
    in_range = bool(((toks >= 0) & (toks < V)).all())
    log(f"[11] prefill {PREFILL} tokens: {pre_s * 1e3:.1f} ms = {PREFILL / pre_s:.1f} tok/s; "
        f"decode {DECODE} tokens at context {PREFILL}: {dec_s * 1e3:.1f} ms = "
        f"{DECODE / dec_s:.2f} tok/s; peak memory {peak:.2f} GiB")
    log(f"[11] launches { {k: v for k, v in counts.items() if v} }; as expected (kernel 15 "
        f"x {4 * NL} and kernel A x 1 a step and a chunk, the chunk's 15 by the wgmma kernel): "
        f"{good}; logits finite: {finite}; "
        f"tokens in vocab: {in_range}")
    ok &= good and finite and in_range
    prof = profile_decode(torch, rt, kv, n_past + DECODE + 1, toks[:, -1:], tag="11")
    gemv_ms = kernel_ms(prof, "qmatmul4_gemv_kernel")
    tiled_ms = kernel_ms(prof, "qmatmul4_wgmma_kernel", "qmatmul4_kernel<")
    log(f"[11] decode step: qmatmul4_gemv_kernel {gemv_ms:.3f} ms ({4 * NL} launches), the "
        f"tiled forms (qmatmul4_wgmma_kernel, qmatmul4_kernel) {tiled_ms:.3f} ms, every kernel "
        f"{sum(prof.values()):.3f} ms")
    ok &= gemv_ms > 0 and tiled_ms == 0
    del kv
    kv = rt.new_cache(1, PREFILL + 8)
    prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv, 0), 1,
                          f"one {PREFILL}-token prefill chunk", "chunk", "11")
    tiled_ms, every = kernel_ms(prof, "qmatmul4_wgmma_kernel"), sum(prof.values())
    log(f"[11] prefill chunk: the tiled qmatmul4_wgmma_kernel {tiled_ms:.3f} ms of {every:.3f} ms "
        f"of kernels ({100 * tiled_ms / every:.1f}%), qmatmul4_gemv_kernel "
        f"{kernel_ms(prof, 'qmatmul4_gemv_kernel'):.3f} ms, the mma.sync qmatmul4_kernel "
        f"{kernel_ms(prof, 'qmatmul4_kernel<'):.3f} ms")
    del kv, logits
    rt.params["blocks"] = rt.params["blocks"][:2]
    rt.cfg = replace(rt.cfg, n_layer=2)
    torch.cuda.empty_cache()
    ids = [int(x) for x in np.random.default_rng(9).integers(3, V, 128)]
    _, lk, lp, _, _, _ = forced_parity(torch, rt, ids, 16)
    good, text = parity_verdict(lk, lp)
    log(f"[11] depth-2 parity, kernel path vs plain path: {text}: "
        f"{'ok' if good else 'FAIL'}; {time.perf_counter() - t_phase:.1f} s in all")
    del rt
    torch.cuda.empty_cache()
    return ok and good


# --------------------------------------------------- phase 17: the family --
LONG17, DECODE17 = 4000, 64      # phase 17's cached tokens and decode steps


def build_family_gguf(path: Path, c: dict) -> Path:
    """One block of architecture c["ARCH"] at the width ``c`` (Q4_0 block
    linears and experts, Q8_0 embedding and head, tied on the gemmas;
    unit norms; gemma3: QK-norms, linear rope scaling on the global layers;
    gemma2: softcaps; gpt-oss: q/k/v/o biases, sinks, an f32 router with its
    bias and per-expert biases, yarn rope), random blocks from seed 0;
    cached beside a .meta. The sliding-window layout comes from the
    config, so the block clones to any depth (``clone_family``)."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=FAMILY_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, e, h, hkv, d, ff, v = (c[k] for k in ("ARCH", "E", "H", "HKV", "D", "FF", "V"))
    w = GGUFWriter(str(path), arch=arch)
    kv = {"block_count": 1, "context_length": c["CTX"], "embedding_length": e,
          "feed_forward_length": ff, "attention.head_count": h,
          "attention.head_count_kv": hkv, "attention.key_length": d,
          "attention.value_length": d, "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.sliding_window": c["WINDOW"], "rope.freq_base": c["ROPE"],
          "rope.dimension_count": d, "vocab_size": v}
    if arch == "gemma3":
        kv.update({"rope.scaling.type": "linear", "rope.scaling.factor": c["ROPE_SCALE"]})
    if arch == "gemma2":
        kv.update({"attn_logit_softcapping": c["SOFTCAP"],
                   "final_logit_softcapping": c["FINAL_SOFTCAP"]})
    if arch == "gpt-oss":
        kv.update({"expert_count": c["G"], "expert_used_count": c["TOPK"],
                   "expert_feed_forward_length": ff, "rope.scaling.type": "yarn",
                   "rope.scaling.factor": 32.0,
                   "rope.scaling.original_context_length": 4096})
    for key, val in kv.items():
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    def small(name, *shape, std=0.1):
        w.add_tensor(name, (rng.standard_normal(shape) * std).astype(np.float32))

    def ones(name, n):
        w.add_tensor(name, np.ones(n, np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    ones("output_norm.weight", e)
    p = "blk.0."
    ones(p + "attn_norm.weight", e)
    q(p + "attn_q.weight", h * d, e)
    q(p + "attn_k.weight", hkv * d, e)
    q(p + "attn_v.weight", hkv * d, e)
    q(p + "attn_output.weight", e, h * d)
    if arch == "gpt-oss":
        q("output.weight", v, e, GGMLType.Q8_0)
        for name, width in (("attn_q", h * d), ("attn_k", hkv * d), ("attn_v", hkv * d),
                            ("attn_output", e)):
            small(p + name + ".bias", width)
        small(p + "attn_sinks.weight", h, std=1.0)
        ones(p + "post_attention_norm.weight", e)          # gpt-oss's pre-FFN norm
        w.add_tensor(p + "ffn_gate_inp.weight",
                     rng.standard_normal((c["G"], e), dtype=np.float32) / np.float32(np.sqrt(e)))
        small(p + "ffn_gate_inp.bias", c["G"])
        q(p + "ffn_gate_exps.weight", ff, e, n=c["G"])
        q(p + "ffn_up_exps.weight", ff, e, n=c["G"])
        q(p + "ffn_down_exps.weight", e, ff, n=c["G"])
        for name, width in (("ffn_gate_exps", ff), ("ffn_up_exps", ff), ("ffn_down_exps", e)):
            small(p + name + ".bias", c["G"], width, std=0.01)
    else:
        if arch == "gemma3":
            ones(p + "attn_q_norm.weight", d)
            ones(p + "attn_k_norm.weight", d)
        for name in ("post_attention_norm", "ffn_norm", "post_ffw_norm"):
            ones(p + name + ".weight", e)
        q(p + "ffn_gate.weight", ff, e)
        q(p + "ffn_up.weight", ff, e)
        q(p + "ffn_down.weight", e, ff)
    w.write()
    mpath.write_text(meta)
    return path


def family_cfg(gguf: Path, n_layer: int):
    """The file's config made anew at depth n_layer, so that the per-layer
    sliding-window layout is the model's at that depth."""
    from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf
    from ik_llama_cpp_tpu_torch.models.config import config_from_gguf
    md = dict(load_gguf(gguf).metadata)
    md[f"{md['general.architecture']}.block_count"] = n_layer
    return config_from_gguf(md)


def clone_family(rt, gguf: Path, n_layer: int):
    """Block 0 cloned into n_layer distinct blocks, with family_cfg."""
    blk0 = rt.params["blocks"][0]
    rt.params["blocks"] = [blk0] + [copy.deepcopy(blk0) for _ in range(n_layer - 1)]
    rt.cfg = family_cfg(gguf, n_layer)
    return rt


def load_family(torch, c: dict, n_layer: int, tag: str):
    """The file of ``c`` built (or found) under build/, loaded through
    Runtime.from_gguf and cloned to n_layer; returns (runtime, load s)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    gguf = build_family_gguf(ROOT / "build" / f"smoke_{c['ARCH']}.gguf", c)
    t1 = time.perf_counter()
    rt = clone_family(Runtime.from_gguf(gguf, fuse=True), gguf, n_layer)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    log(f"[17] {tag}: {c['ARCH']} L{n_layer} E{c['E']} H{c['H']} KV{c['HKV']} D{c['D']} "
        f"FF{c['FF']} V{c['V']}: file ready in {t1 - t0:.1f} s, loaded in {load_s:.1f} s; "
        f"window {rt.cfg.swa_window} on {sum(map(rt.cfg.layer_is_swa, range(n_layer)))} of "
        f"{n_layer} layers; linears {kinds}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return rt, load_s


def family_parity(torch, rt, n_prompt: int, tag: str, seed: int, phase: str = "17") -> bool:
    """The kernel path against the plain path over one token history (the
    rule of phases 6, 10, 11 and 13: every step's logits within 5% of the
    largest logit)."""
    t0 = time.perf_counter()
    ids = [int(x) for x in np.random.default_rng(seed).integers(3, rt.cfg.n_vocab, n_prompt)]
    reset_counts()
    _, lk, lp, kvk, kvp, _ = forced_parity(torch, rt, ids, 16)
    counts = {k: n for k, n in read_counts().items() if n}
    good, text = parity_verdict(lk, lp)
    log(f"[{phase}] parity {tag}, {n_prompt}-token prompt and 16 steps: {text}: "
        f"{'ok' if good else 'FAIL'}; kernel launches {counts} "
        f"({time.perf_counter() - t0:.1f} s)")
    del kvk, kvp
    return good and bool(counts)


def ring_attention_ms(torch, rt, kv, n_past: int) -> float:
    """The plain ring attention of one decode step: ``attend`` over every
    ring layer's slots at n_past, timed with CUDA events (ms a step)."""
    from ik_llama_cpp_tpu_torch.models import llama
    from ik_llama_cpp_tpu_torch.ops.attention import attend
    cfg, ring = rt.cfg, kv.swa_cap
    q = torch.randn((1, 1, cfg.n_head, cfg.head_dim), device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor([n_past + 1], dtype=torch.int32, device="cuda")
    q_pos = kv_len[:, None] - 1
    layers = [i for i in range(cfg.n_layer) if kv.ring(i)]

    def step():
        for i in layers:
            attend(q, kv.k[i], kv.v[i], q_pos=q_pos, kv_len=kv_len,
                   scale=cfg.f_attention_scale, swa_window=cfg.swa_window,
                   key_positions=llama._ring_positions(kv_len, ring))
    step()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        step()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / 5


def phase_family(torch, launches: dict) -> bool:
    """Phase 17: the llama-graph family. Gemma-3-12B at full width (L17 layers): a
    3,999-token prefill in chunks and 64 greedy decode steps at 4,000
    cached tokens over a bf16 cache, launch counts and a decode profile;
    the same over --swa-compress ring caches; then three one-history
    parities: Gemma-3-12B at depth 6 over 1,100 tokens, the Gemma-2-9B
    width and the gpt-oss-20b width at depth 2."""
    c = GEMMA3
    t_phase = time.perf_counter()
    rt, load_s = load_family(torch, c, L17, "full width")
    nl = L17
    n_ring = sum(map(rt.cfg.layer_is_swa, range(nl)))
    ids = [int(x) for x in np.random.default_rng(17).integers(3, c["V"], LONG17 - 1)]
    rt.eval_tokens(ids[:8], rt.new_cache(1, 64), 0)                  # warm-up
    kv = rt.new_cache(1, LONG17 + DECODE17)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_pre = read_counts()
    reset_counts()
    toks = rt._decode_loop(first, kv, n_past, DECODE17)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()
    chunks = -(-len(ids) // 512)
    per = 4 * nl + 1                 # fused qkv, wo, fused gate/up, down a layer; the head
    want_pre = {"qmatmul_i8": per * chunks, "flash_attention": nl * chunks}
    want_dec = {"qmatmul_i8": per * DECODE17, "flash_attention_decode": nl * DECODE17}
    got_pre = {k: n for k, n in counts_pre.items() if n}
    got_dec = {k: n for k, n in counts.items() if n}
    for k in ("qmatmul_i8", "flash_attention", "flash_attention_decode"):
        launches[k] = launches.get(k, 0) + counts_pre[k] + counts[k]
    finite = bool(torch.isfinite(logits).all())
    ok = got_pre == want_pre and got_dec == want_dec and finite and \
        bool(((toks >= 0) & (toks < c["V"])).all())
    log(f"[17] prefill {len(ids)} tokens in {chunks} chunks: {(t1 - t0) * 1e3:.1f} ms = "
        f"{len(ids) / (t1 - t0):.1f} tok/s; decode {DECODE17} tokens at {n_past + 1}-"
        f"{n_past + DECODE17} cached: {(t2 - t1) * 1e3:.1f} ms = "
        f"{DECODE17 / (t2 - t1):.2f} tok/s; load {load_s:.1f} s")
    log(f"[17] launches: prefill {got_pre} (expected {want_pre}), decode {got_dec} "
        f"(expected {want_dec}): A {got_dec.get('qmatmul_i8', 0) / DECODE17:g} and C "
        f"{got_dec.get('flash_attention_decode', 0) / DECODE17:g} a step; logits finite "
        f"{finite}: {'ok' if ok else 'FAIL'}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE17, toks[:, -1:], tag="17", top=8,
                          host=False)
    log(f"[17] decode step at {n_past + DECODE17} cached: kernel A {a_ms(prof)}; "
        f"{c_ms(prof)}; all kernels {sum(prof.values()):.3f} ms")
    full_bytes = _cache_bytes(kv)
    del kv, logits
    torch.cuda.empty_cache()

    # the same decode over ring caches on the window layers
    rt.swa_compress = True
    kvr = rt.new_cache(1, LONG17 + DECODE17)
    reset_counts()
    lr, kvr, n_r = rt.eval_tokens(ids, kvr, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks_r = rt._decode_loop(torch.argmax(lr[-1]).reshape(1, 1), kvr, n_r, DECODE17)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts_r = {k: n for k, n in read_counts().items() if n}
    ring_ms = ring_attention_ms(torch, rt, kvr, n_r + DECODE17)
    same = int((toks_r == toks).sum())
    ring_ok = (type(kvr).__name__ == "SwaKVCache" and bool(torch.isfinite(lr).all())
               and counts_r.get("flash_attention_decode", 0) == (nl - n_ring) * DECODE17)
    log(f"[17] ring caches: {sum(m < 0 for m in kvr.layer_map)} ring layers of "
        f"{kvr.swa_cap} rows, {sum(m >= 0 for m in kvr.layer_map)} full of {kvr.capacity}: "
        f"{_cache_bytes(kvr) / 2**30:.3f} GiB against {full_bytes / 2**30:.3f} GiB; decode "
        f"{DECODE17} tokens {(t2 - t1) * 1e3:.1f} ms = {DECODE17 / (t2 - t1):.2f} tok/s; the "
        f"plain ring attention {ring_ms:.3f} ms a step ({n_ring} layers); greedy tokens the full "
        f"cache's at {same} of {DECODE17} steps; launches {counts_r}: "
        f"{'ok' if ring_ok else 'FAIL'}")
    prof = profile_decode(torch, rt, kvr, n_r + DECODE17, toks_r[:, -1:], tag="17 ring", top=8,
                          host=False)
    log(f"[17] ring decode step: kernel A {a_ms(prof)}; {c_ms(prof)}; all kernels "
        f"{sum(prof.values()):.3f} ms")
    del kvr
    torch.cuda.empty_cache()
    eng_ok, eng_text = ring_engine(torch, rt, ids)
    log(f"[17] ring-cache engine: {eng_text}: {'ok' if eng_ok else 'FAIL'}")
    ok &= eng_ok
    rt.swa_compress = False
    del lr
    ok &= ring_ok
    log(f"[17] Gemma-3-12B at L{nl}, bf16 and ring caches: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # one-history parities: Gemma-3-12B at depth 6 (five window layers, one
    # global) over a prompt longer than its window
    rt.params["blocks"] = rt.params["blocks"][:6]
    rt.cfg = family_cfg(ROOT / "build" / "smoke_gemma3.gguf", 6)
    ok &= family_parity(torch, rt, 1100, "Gemma-3-12B at depth 6", 18)
    del rt
    torch.cuda.empty_cache()
    for cfg_, n_prompt, seed, tag in ((GEMMA2, 1100, 19, "Gemma-2-9B width at depth 2"),
                                      (GPTOSS, 300, 20, "gpt-oss-20b width at depth 2")):
        rt, _ = load_family(torch, cfg_, 2, tag)
        ok &= family_parity(torch, rt, n_prompt, tag, seed)
        del rt
        torch.cuda.empty_cache()
    return ok


def ring_engine(torch, rt, ids: list) -> tuple:
    """A 2-slot BatchEngine over ring caches (``rt.swa_compress``), stepped
    in this thread: requests A (1,800 of ``ids``) and B (300 others) at
    once, then C (A's first 1,700 and 60 new: a prefix past the window,
    which the reuse rule takes) and D (A's first 200 and 40 new: the ring
    no longer holds that prefix's window, so the slot prefills from 0),
    each in slot 0 after the last; every request's greedy tokens held to
    the runtime's ring tokens for its prompt alone (held_to). Returns (ok,
    text)."""
    import queue
    from ik_llama_cpp_tpu_torch.models.llama import SwaKVCache
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
    cap = 2304
    eng = BatchEngine(rt, n_slots=2, capacity=cap)
    rng = np.random.default_rng(171)
    fresh = [int(x) for x in rng.integers(3, rt.cfg.n_vocab, 400)]
    rounds = [[("A", ids[:1800]), ("B", fresh[:300])],
              [("C", ids[:1700] + fresh[300:360])], [("D", ids[:200] + fresh[360:400])]]
    ok = isinstance(eng.kv, SwaKVCache)
    texts, n_tok, t0 = [], 0, time.perf_counter()
    for batch in rounds:
        cached0 = eng.n_prompt_tokens_cached
        reqs = []
        for name, p in batch:
            r = Request(prompt_ids=p, n_predict=ENGINE17_NEW, sampler=SamplerParams(temp=0.0))
            r.stream_queue = queue.Queue()
            eng.submit(r)
            reqs.append((name, p, r))
        while eng.step():
            pass
        cached = eng.n_prompt_tokens_cached - cached0
        for name, p, r in reqs:
            got = []
            while True:
                tok, _, done = r.stream_queue.get(timeout=0)
                if tok >= 0:
                    got.append(tok)
                if done:
                    break
            n_tok += len(got)
            want = rt.generate_greedy_on_device(p, ENGINE17_NEW, capacity=cap)[1]
            good, text = held_to(torch, rt, p, got, want)
            ok &= good
            texts.append(f"{name} ({len(p)}-token prompt, {cached} reused): {text}")
        if batch[0][0] == "C":
            ok &= cached == 1700
        elif batch[0][0] == "D":
            ok &= cached == 0
    wall = time.perf_counter() - t0
    ok &= eng.n_failed == 0
    del eng
    torch.cuda.empty_cache()
    return ok, (f"4 requests in {wall:.2f} s ({n_tok / wall:.1f} tok/s over both slots, the "
                f"runtime's replays included): " + " | ".join(texts))


def build_ds_gguf(path: Path, c: dict) -> Path:
    """Two blocks of the DeepSeek-2 family at the width ``c``: the dense
    lead and one MoE layer (Q4_0 attention, FFN, experts and shared
    experts; Q8_0 embedding and untied head; an f32 router, with a
    selection bias where c["BIAS"]; unit norms; YaRN rope). glm-dsa: the
    pre-split attn_k_b / attn_v_b (Q4_0) and a Q8_0 lightning indexer on
    both blocks. Random blocks from seed 0, cached beside a .meta; the MoE
    block clones to any depth (``load_ds``)."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=DS_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, e, h, v = c["ARCH"], c["E"], c["H"], c["V"]
    nope, rope, dv, lkv, lq = c["NOPE"], c["ROPE"], c["DV"], c["LORA_KV"], c["LORA_Q"]
    g, ff, ffs, ffd = c["G"], c["FF"], c["NSH"] * c["FF"], c["FFD"]
    w = GGUFWriter(str(path), arch=arch)
    kv = {"block_count": 2, "context_length": 163840, "embedding_length": e,
          "feed_forward_length": ffd, "attention.head_count": h,
          "attention.head_count_kv": h, "attention.key_length": nope + rope,
          "attention.value_length": dv, "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.kv_lora_rank": lkv, "rope.freq_base": 10000.0,
          "rope.dimension_count": rope, "rope.scaling.type": "yarn",
          "rope.scaling.factor": 40.0, "rope.scaling.original_context_length": 4096,
          "rope.scaling.yarn_log_multiplier": 0.0707, "leading_dense_block_count": 1,
          "expert_count": g, "expert_used_count": c["TOPK"],
          "expert_shared_count": c["NSH"], "expert_feed_forward_length": ff,
          "expert_weights_scale": c["SCALE"], "expert_weights_norm": c["NORM"],
          "expert_gating_func": c["GATING"], "vocab_size": v}
    if lq:
        kv["attention.q_lora_rank"] = lq
    if "IDX_H" in c:
        kv.update({"attention.indexer.head_count": c["IDX_H"],
                   "attention.indexer.key_length": c["IDX_D"],
                   "attention.indexer.top_k": c["IDX_K"]})
    for key, val in kv.items():
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    def ones(name, n):
        w.add_tensor(name, np.ones(n, np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    q("output.weight", v, e, GGMLType.Q8_0)
    ones("output_norm.weight", e)
    for i in range(2):
        p = f"blk.{i}."
        for name, n in (("attn_norm", e), ("attn_kv_a_norm", lkv), ("ffn_norm", e)):
            ones(p + name + ".weight", n)
        if lq:
            q(p + "attn_q_a.weight", lq, e)
            ones(p + "attn_q_a_norm.weight", lq)
            q(p + "attn_q_b.weight", h * (nope + rope), lq)
        else:
            q(p + "attn_q.weight", h * (nope + rope), e)
        q(p + "attn_kv_a_mqa.weight", lkv + rope, e)
        if arch == "glm-dsa":
            q(p + "attn_k_b.weight", lkv, nope, n=h)     # ne (nope, lora_kv, h)
            q(p + "attn_v_b.weight", dv, lkv, n=h)       # ne (lora_kv, dv, h)
            q(p + "indexer.attn_q_b.weight", c["IDX_H"] * c["IDX_D"], lq, GGMLType.Q8_0)
            q(p + "indexer.attn_k.weight", c["IDX_D"], e, GGMLType.Q8_0)
            ones(p + "indexer.k_norm.weight", c["IDX_D"])
            w.add_tensor(p + "indexer.k_norm.bias",
                         (rng.standard_normal(c["IDX_D"]) * 0.05).astype(np.float32))
            q(p + "indexer.proj.weight", c["IDX_H"], e, GGMLType.Q8_0)
        else:
            q(p + "attn_kv_b.weight", h * (nope + dv), lkv)
        q(p + "attn_output.weight", e, h * dv)
        if i == 0:
            q(p + "ffn_gate.weight", ffd, e)
            q(p + "ffn_up.weight", ffd, e)
            q(p + "ffn_down.weight", e, ffd)
            continue
        w.add_tensor(p + "ffn_gate_inp.weight",
                     rng.standard_normal((g, e), dtype=np.float32) / np.float32(np.sqrt(e)))
        if c["BIAS"]:
            w.add_tensor(p + "exp_probs_b.bias",
                         (rng.standard_normal(g) * 0.05).astype(np.float32))
        q(p + "ffn_gate_exps.weight", ff, e, n=g)
        q(p + "ffn_up_exps.weight", ff, e, n=g)
        q(p + "ffn_down_exps.weight", e, ff, n=g)
        q(p + "ffn_gate_shexp.weight", ffs, e)
        q(p + "ffn_up_shexp.weight", ffs, e)
        q(p + "ffn_down_shexp.weight", e, ffs)
    w.write()
    mpath.write_text(meta)
    return path


def load_ds(torch, c: dict, n_layer: int, tag: str, mla: bool = True, device="cuda"):
    """c's file built (or found) under build/ and loaded: through
    Runtime.from_gguf (the latent cache), or with mla=False through the
    loader's per-head form; its MoE block cloned into distinct blocks to
    n_layer layers behind the dense lead. Returns (runtime, load s)."""
    from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf
    from ik_llama_cpp_tpu_torch.models import deepseek2
    from ik_llama_cpp_tpu_torch.models.config import config_from_gguf
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    gguf = build_ds_gguf(ROOT / "build" / f"smoke_{c['TAG']}.gguf", c)
    t1 = time.perf_counter()
    if mla:
        rt = Runtime.from_gguf(gguf, device, fuse=True)
    else:
        gg = load_gguf(gguf)
        cfg = config_from_gguf(gg.metadata)
        rt = Runtime(cfg=cfg, params=deepseek2.load_deepseek2_params(
            gg, cfg, torch.device(device), mla=False), device=torch.device(device))
    blocks = rt.params["blocks"]
    rt.params["blocks"] = blocks[:2] + [copy.deepcopy(blocks[1]) for _ in range(n_layer - 2)]
    rt.cfg = replace(rt.cfg, n_layer=n_layer)
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    experts = blocks[1]["experts"]
    forms = {p: ("supergroup int8" if getattr(experts, p + "_group") == 256 else
                 f"planar group {getattr(experts, p + '_group')}")
             for p in ("gate", "up", "down")} if hasattr(experts, "gate_group") else "bf16"
    log(f"[18] {tag}: {c['ARCH']} L{n_layer} E{c['E']} H{c['H']} kv-lora {c['LORA_KV']} "
        f"q-lora {c['LORA_Q']} G{c['G']} top-{c['TOPK']} FF{c['FF']} V{c['V']} "
        f"(mla={mla}): file ready in {t1 - t0:.1f} s, loaded in {load_s:.1f} s; linears "
        f"{kinds}; experts {forms}" + (f"; device memory "
                                       f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB"
                                       if rt.device.type == "cuda" else ""))
    return rt, load_s


def serve_two(torch, rt, seed: int, n_predict: int = 24):
    """Two greedy requests at once on a 2-slot BatchEngine (the second in
    slot 1, a row view of the shared latent cache), stepped in this
    thread; then each replayed at B = 1 (replay_verdict). Returns (ok,
    text)."""
    import queue
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(3, rt.cfg.n_vocab, n)] for n in (300, 120)]
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    qs = []
    t0 = time.perf_counter()
    for p in prompts:
        r = Request(prompt_ids=p, n_predict=n_predict, sampler=SamplerParams(temp=0.0))
        r.stream_queue = queue.Queue()
        eng.submit(r)
        qs.append(r.stream_queue)
    while eng.step():
        pass
    wall = time.perf_counter() - t0
    gens = []
    for q_ in qs:
        toks = []
        while True:
            tok, _, done = q_.get(timeout=0)
            if tok >= 0:
                toks.append(tok)
            if done:
                break
        gens.append(toks)
    ok = eng.n_failed == 0 and eng.slots[1].cache_tokens[:len(prompts[1])] == prompts[1]
    texts = []
    for p, gen_ in zip(prompts, gens):
        good, text = replay_verdict(torch, rt, p, gen_)
        ok &= good and len(gen_) > 0
        texts.append(f"{len(p)}-token prompt, {len(gen_)} tokens: {text}")
    del eng
    return ok, (f"2 requests in {wall:.2f} s ({sum(map(len, gens)) / wall:.1f} tok/s over "
                f"both slots, slot 1 served the second): " + " | ".join(texts))


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event ms of ``fn`` over reps calls after a warm call,
    each enqueued while the card sleeps for about half a millisecond, so
    that the host's launch cost stays out of the device time (as Timer)."""
    fn()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def absorb_ms(torch, blk: dict, t: int) -> tuple:
    """A layer's two absorb products at T tokens as models/deepseek2 runs
    them (q_nope @ wk_b and attn @ wv_b in float32, with the weights' bf16
    to float32 casts): (ms, ms)."""
    h, nope, lora = blk["wk_b"].shape
    q = torch.randn((1, t, h, nope), device="cuda")
    a = torch.randn((1, t, h, lora), device="cuda").to(torch.bfloat16)
    return (event_ms(torch, lambda: torch.einsum("bthd,hdl->bthl", q.float(),
                                                  blk["wk_b"].float())),
            event_ms(torch, lambda: torch.einsum("bthl,hlv->bthv", a.float(),
                                                 blk["wv_b"].float())))


def phase_deepseek(torch, launches: dict, card: str) -> bool:
    """Phase 18: the DeepSeek-2 family. DeepSeek-V2-Lite at full width
    (16 of its 27 layers) on the latent cache: the load, a 3,999-token prefill in 512-token
    chunks and 64 greedy decode steps at 4,000 cached tokens, the launches
    a step by kernel, decode and prefill profiles, the cache's bytes beside
    the per-head cache's, two requests on a 2-slot BatchEngine; then four
    one-history parities at depth 2: (a) the V2-Lite widths, (b)
    DeepSeek-V3's routing with a q-lora, (c) mla=False, (d) glm-dsa's
    indexer over a 2,100-token prompt."""
    c = DSV2
    nl = L18
    t_phase = time.perf_counter()
    rt, load_s = load_ds(torch, c, nl, "full width")
    ids = [int(x) for x in np.random.default_rng(18).integers(3, c["V"], LONG18 - 1)]
    rt.eval_tokens(ids[:8], rt.new_cache(1, 64), 0)                  # warm-up
    kv = rt.new_cache(1, LONG18 + DECODE18)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_pre = read_counts()
    reset_counts()
    toks = rt._decode_loop(first, kv, n_past, DECODE18)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()
    chunks = -(-len(ids) // 512)
    for k in counts:
        launches[k] = launches.get(k, 0) + counts_pre[k] + counts[k]
    got_pre = {k: n for k, n in counts_pre.items() if n}
    got_dec = {k: n for k, n in counts.items() if n}
    # the absorb path's attention: the MLA form once a layer a forward, at
    # every T; no other attention kernel
    want_attn = lambda n: {"flash_attention": nl * n, "flash_attention_mla": nl * n}
    attn_keys = ("flash_attention", "flash_attention_mla", "flash_attention_decode",
                 "flash_attention_q8", "flash_attention_decode_q8")
    attn_ok = ({k: got_pre[k] for k in attn_keys if k in got_pre} == want_attn(chunks)
               and {k: got_dec[k] for k in attn_keys if k in got_dec} == want_attn(DECODE18))
    finite = bool(torch.isfinite(logits).all())
    ok = attn_ok and finite and bool(((toks >= 0) & (toks < c["V"])).all())
    log(f"[18] on {card}: prefill {len(ids)} tokens in {chunks} chunks: "
        f"{(t1 - t0) * 1e3:.1f} ms = {len(ids) / (t1 - t0):.1f} tok/s; decode {DECODE18} "
        f"tokens at {n_past + 1}-{n_past + DECODE18} cached: {(t2 - t1) * 1e3:.1f} ms = "
        f"{DECODE18 / (t2 - t1):.2f} tok/s; load {load_s:.1f} s")
    log(f"[18] launches a prefill chunk: "
        f"{ {k: round(n / chunks, 2) for k, n in got_pre.items()} }; a decode step: "
        f"{ {k: round(n / DECODE18, 2) for k, n in got_dec.items()} }; the MLA form "
        f"{got_pre.get('flash_attention_mla', 0) / chunks:g} a chunk and "
        f"{got_dec.get('flash_attention_mla', 0) / DECODE18:g} a step (expected {nl}), no "
        f"other attention kernel: {attn_ok}; logits finite {finite}: {'ok' if ok else 'FAIL'}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE18, toks[:, -1:], tag="18", top=10,
                          host=False)
    mla_dec = kernel_ms(prof, "fa_mla_decode_kernel", "fa_mla_wgmma_kernel")
    log(f"[18] decode step at {n_past + DECODE18} cached: the MLA form (fa_mla_decode_kernel) "
        f"{mla_dec:.3f} ms; kernel A {a_ms(prof)}; all kernels {sum(prof.values()):.3f} ms")
    tail = ids[-(len(ids) % 512 or 512):]
    prof = profile_window(torch, lambda: rt.eval_tokens(tail, kv, len(ids) - len(tail)), 1,
                          f"the last prefill chunk ({len(tail)} tokens at "
                          f"{len(ids) - len(tail)} cached)", "chunk", "18", top=10, host=False)
    mla_pre = kernel_ms(prof, "fa_mla_decode_kernel", "fa_mla_wgmma_kernel")
    log(f"[18] last prefill chunk: the MLA form (fa_mla_wgmma_kernel) {mla_pre:.3f} ms; "
        f"kernel A {a_ms(prof)}; all kernels {sum(prof.values()):.3f} ms")
    if not (mla_dec > 0 and mla_pre > 0):
        log("[18] FAIL: the MLA form launched but the profile shows none of its kernels' time")
        ok = False
    ab1, ab512 = absorb_ms(torch, rt.params["blocks"][1], 1), \
        absorb_ms(torch, rt.params["blocks"][1], 512)
    log(f"[18] the absorb products a layer (q_nope @ wk_b, attn @ wv_b; plain f32 einsums): "
        f"T=1 {ab1[0]:.4f} + {ab1[1]:.4f} ms, {nl * sum(ab1):.3f} ms a decode step; T=512 "
        f"{ab512[0]:.4f} + {ab512[1]:.4f} ms, {nl * sum(ab512):.3f} ms a chunk")
    cap = kv.capacity
    latent = _cache_bytes(kv)
    per_head = nl * cap * c["H"] * (c["NOPE"] + c["ROPE"] + c["DV"]) * 2
    log(f"[18] cache at capacity {cap}: latent {latent / 2**20:.1f} MiB ({tuple(kv.k.shape)} "
        f"bf16, no second tensor) against the mla=False per-head cache "
        f"{per_head / 2**20:.1f} MiB ({nl} x {cap} x {c['H']} x "
        f"({c['NOPE'] + c['ROPE']} + {c['DV']}) bf16, reckoned from shapes): "
        f"{per_head / latent:.2f}x")
    del kv, logits
    torch.cuda.empty_cache()
    good, text = serve_two(torch, rt, 181)
    log(f"[18] BatchEngine at L{nl}: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    log(f"[18] DeepSeek-V2-Lite at L{nl}: {time.perf_counter() - t_phase:.1f} s")

    # one-history parities at depth 2: (a) the loaded model's dense lead and
    # first MoE layer
    rt.params["blocks"] = rt.params["blocks"][:2]
    rt.cfg = replace(rt.cfg, n_layer=2)
    ok &= family_parity(torch, rt, 300, "(a) DeepSeek-V2-Lite widths at depth 2", 21, "18")
    del rt
    torch.cuda.empty_cache()
    for cfg_, mla, n_prompt, seed, tag in (
            (DSV3R, True, 300, 22, "(b) DeepSeek-V3 routing, q-lora 1536, at depth 2"),
            (DSV2, False, 300, 23, "(c) mla=False (kernel B at 16 / 16 heads of 192 / 128)"),
            (GLMDSA, True, 2100, 24, "(d) glm-dsa, indexer top-k 2,048 of 2,100 keys")):
        rt, _ = load_ds(torch, cfg_, 2, tag, mla=mla)
        ok &= family_parity(torch, rt, n_prompt, tag, seed, "18")
        del rt
        torch.cuda.empty_cache()
    return ok


# --------------------------------------------- phase 19: the hybrid family --
def build_qnext_gguf(path: Path, c: dict) -> Path:
    """Four blocks of Qwen3-Next at the width ``c``: three gated delta-net
    layers and one full-attention layer (Q4_0 ssm_in, ssm_out, gated wq,
    wk, wv, wo, experts and shared expert; an f32 conv kernel, ssm_ba,
    routers and gates; Q8_0 embedding and untied head; unit norms; a
    negative ssm_a). Random blocks from seed 0, cached beside a .meta; the
    four clone to any depth that is a multiple of 4 (``load_qnext``)."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=QNEXT_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, e, h, hkv, d, v = c["ARCH"], c["E"], c["H"], c["HKV"], c["D"], c["V"]
    hk, hv, dk, dv, g, ff = c["HK"], c["HV"], c["DK"], c["DV"], c["G"], c["FF"]
    key_dim, value_dim = hk * dk, hv * dv
    conv_dim = 2 * key_dim + value_dim
    w = GGUFWriter(str(path), arch=arch)
    for key, val in (("block_count", 4), ("context_length", c["CTX"]),
                     ("embedding_length", e), ("feed_forward_length", 5120),
                     ("attention.head_count", h), ("attention.head_count_kv", hkv),
                     ("attention.key_length", d), ("attention.value_length", d),
                     ("attention.layer_norm_rms_epsilon", 1e-6),
                     ("rope.freq_base", c["ROPE"]), ("rope.dimension_count", c["ROPE_DIM"]),
                     ("ssm.conv_kernel", c["CONV"]), ("ssm.inner_size", value_dim),
                     ("ssm.state_size", dk), ("ssm.time_step_rank", hv),
                     ("ssm.group_count", hk), ("full_attention_interval", 4),
                     ("expert_count", g), ("expert_used_count", c["TOPK"]),
                     ("expert_feed_forward_length", ff),
                     ("expert_shared_feed_forward_length", c["FFS"]), ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    def f32(name, rows, cols):
        w.add_tensor(name, rng.standard_normal((rows, cols), dtype=np.float32)
                     / np.float32(np.sqrt(cols)))

    def ones(name, n):
        w.add_tensor(name, np.ones(n, np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    q("output.weight", v, e, GGMLType.Q8_0)
    ones("output_norm.weight", e)
    for i in range(4):
        p = f"blk.{i}."
        ones(p + "attn_norm.weight", e)
        ones(p + "post_attention_norm.weight", e)
        if i < 3:               # gated delta net: per-k-head [q|k|v|z], [b|a]
            q(p + "ssm_in.weight", 2 * key_dim + 2 * value_dim, e)
            f32(p + "ssm_conv1d.weight", conv_dim, c["CONV"])
            w.add_tensor(p + "ssm_dt.bias", rng.standard_normal(hv, dtype=np.float32))
            w.add_tensor(p + "ssm_a", -np.abs(rng.standard_normal(hv, dtype=np.float32)))
            f32(p + "ssm_ba.weight", 2 * hv, e)
            ones(p + "ssm_norm.weight", dv)
            q(p + "ssm_out.weight", e, value_dim)
        else:                   # full attention, per-head [q | gate]
            q(p + "attn_q.weight", h * d * 2, e)
            q(p + "attn_k.weight", hkv * d, e)
            q(p + "attn_v.weight", hkv * d, e)
            q(p + "attn_output.weight", e, h * d)
            ones(p + "attn_q_norm.weight", d)
            ones(p + "attn_k_norm.weight", d)
        f32(p + "ffn_gate_inp.weight", g, e)
        q(p + "ffn_gate_exps.weight", ff, e, n=g)
        q(p + "ffn_up_exps.weight", ff, e, n=g)
        q(p + "ffn_down_exps.weight", e, ff, n=g)
        f32(p + "ffn_gate_inp_shexp.weight", 1, e)
        q(p + "ffn_gate_shexp.weight", c["FFS"], e)
        q(p + "ffn_up_shexp.weight", c["FFS"], e)
        q(p + "ffn_down_shexp.weight", e, c["FFS"])
    w.write()
    mpath.write_text(meta)
    return path


def load_qnext(torch, c: dict, n_layer: int, device="cuda"):
    """c's four-block file built (or found) under build/, loaded through
    Runtime.from_gguf and cloned into distinct device blocks to n_layer
    layers (block i a copy of block i % 4, so the attention layers stay
    every 4th). Returns (runtime, file s, load s)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    gguf = build_qnext_gguf(ROOT / "build" / "smoke_qwen3next.gguf", c)
    t1 = time.perf_counter()
    rt = Runtime.from_gguf(gguf, device)
    four = rt.params["blocks"]
    rt.params["blocks"] = four + [copy.deepcopy(four[i % 4]) for i in range(4, n_layer)]
    rt.cfg = replace(rt.cfg, n_layer=n_layer)
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return rt, t1 - t0, time.perf_counter() - t1


def delta_net_ms(torch, c: dict, t: int, reps: int = 3) -> tuple:
    """One delta-net layer's recurrence (ops/delta_net, plain PyTorch) at T
    tokens on the card: (device ms a call, the sum of its kernels' times
    under torch.profiler; launches a call; the host's wall ms a call
    around a synchronize, unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ik_llama_cpp_tpu_torch.ops.delta_net import delta_net
    gen = torch.Generator(device="cuda").manual_seed(19)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k = rnd(1, t, c["HK"], c["DK"]), rnd(1, t, c["HK"], c["DK"])
    v, beta, g = rnd(1, t, c["HV"], c["DV"]), rnd(1, t, c["HV"]), -rnd(1, t, c["HV"]).abs()
    state = rnd(1, c["HV"], c["DV"], c["DV"]) * 0.01

    def call():
        return delta_net(q, k, v, g, beta, state)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    n = sum(e.count for e in rows) // reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    return dev, n, (time.perf_counter() - t0) / reps * 1e3


def serve_interleaved(torch, rt, seed: int, n_predict: int = 24):
    """Two greedy requests on a 2-slot BatchEngine over the hybrid cache,
    stepped in this thread: the second (700 tokens, two chunks) submitted
    once the first decodes, so that its chunks run between the first's
    decode steps with its own row at n_valid 0 in them; then each replayed
    at B = 1 (replay_verdict). Returns (ok, text)."""
    import queue
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, SlotState
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(3, rt.cfg.n_vocab, n)] for n in (120, 700)]
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    reqs = []

    def submit(p):
        r = Request(prompt_ids=p, n_predict=n_predict, sampler=SamplerParams(temp=0.0))
        r.stream_queue = queue.Queue()
        eng.submit(r)
        reqs.append(r)

    t0 = time.perf_counter()
    submit(prompts[0])
    for _ in range(8):            # its prompt, then two decode steps
        if eng.slots[0].state == SlotState.GENERATING and eng.slots[0].n_decoded >= 2:
            break
        eng.step()
    submit(prompts[1])
    interleaved = 0
    while eng.step():
        interleaved += eng.slots[1].state == SlotState.PREFILL and eng.slots[0].req is not None
    wall = time.perf_counter() - t0
    gens = []
    for r in reqs:
        toks = []
        while True:
            tok, _, done = r.stream_queue.get(timeout=0)
            if tok >= 0:
                toks.append(tok)
            if done:
                break
        gens.append(toks)
    ok = eng.n_failed == 0 and interleaved > 0
    texts = []
    for p, gen_ in zip(prompts, gens):
        good, text = replay_verdict(torch, rt, p, gen_, step_by_step=True)
        ok &= good and len(gen_) == n_predict
        texts.append(f"{len(p)}-token prompt, {len(gen_)} tokens: {text}")
    del eng
    return ok, (f"2 requests in {wall:.2f} s ({sum(map(len, gens)) / wall:.1f} tok/s over both "
                f"slots; the second's chunks beside the first's decode in {interleaved} loop "
                f"rounds): " + " | ".join(texts))


def phase_qnext(torch, launches: dict, card: str, replay: dict) -> bool:
    """Phase 19: the hybrid gated-delta-net family. Qwen3-Next-80B-A3B at
    full width, 8 layers (6 delta-net, 2 attention), on the recurrent
    HybridCache: the load, a 1,024-token prefill in two chunks and 64
    greedy decode steps with every kernel launch counted, decode and
    prefill profiles, the delta-net recurrence's eager ms, two requests on
    a 2-slot BatchEngine, then a one-history parity at depth 4. Fills
    ``replay`` with the router's bucket sizes (row 9q)."""
    from ik_llama_cpp_tpu_torch.models.qwen3next import _interval, is_recurrent
    c = QNEXT
    nl = c["LRUN"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rt, file_s, load_s = load_qnext(torch, c, nl)
    n_delta = sum(is_recurrent(i, _interval(rt.cfg)) for i in range(nl))
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    experts = rt.params["blocks"][0]["experts"]
    log(f"[19] qwen3next L{nl} ({n_delta} delta-net, {nl - n_delta} attention) E{c['E']} "
        f"H{c['H']} KV{c['HKV']} D{c['D']} rope {c['ROPE_DIM']} dims; delta-net {c['HK']} k / "
        f"{c['HV']} v heads of {c['DK']}; G{c['G']} top-{c['TOPK']} FF{c['FF']} + shared "
        f"FF{c['FFS']}; V{c['V']}: file ready in {file_s:.1f} s, loaded and cloned in "
        f"{load_s:.1f} s; linears {kinds}; experts group {experts.gate_group} / "
        f"{experts.up_group} / {experts.down_group}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(19)
    rt.eval_tokens([int(x) for x in rng.integers(3, c["V"], 8)], rt.new_cache(1, 64), 0)
    ids = [int(x) for x in rng.integers(3, c["V"], PREFILL19)]
    kv = rt.new_cache(1, PREFILL19 + DECODE19 + 8)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_pre = read_counts()
    reset_counts()
    toks = rt._decode_loop(first, kv, n_past, DECODE19)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = -(-len(ids) // 512)
    for k in counts:
        launches[k] = launches.get(k, 0) + counts_pre[k] + counts[k]
    n_attn = nl - n_delta
    # A a layer: ssm_in + ssm_out or wq, wk, wv, wo; the shared expert's
    # three; the head once a forward
    per_a = 5 * n_delta + 7 * n_attn + 1
    want_pre = {"qmatmul_i8": per_a * chunks, "flash_attention": n_attn * chunks,
                "fused_moe_prefill_i8": nl * chunks, "ragged_qmatmul_i8": 3 * nl * chunks}
    want_dec = {"qmatmul_i8": per_a * DECODE19, "flash_attention_decode": n_attn * DECODE19,
                "moe_decode_gate_up_i8": nl * DECODE19, "moe_decode_down_i8": nl * DECODE19}
    got_pre = {k: n for k, n in counts_pre.items() if n}
    got_dec = {k: n for k, n in counts.items() if n}
    launch_ok = got_pre == want_pre and got_dec == want_dec
    finite = bool(torch.isfinite(logits).all())
    ok = launch_ok and finite and bool(((toks >= 0) & (toks < c["V"])).all())
    log(f"[19] on {card}: prefill {len(ids)} tokens in {chunks} chunks: "
        f"{(t1 - t0) * 1e3:.1f} ms = {len(ids) / (t1 - t0):.1f} tok/s; decode {DECODE19} tokens "
        f"at {n_past + 1}-{n_past + DECODE19} cached: {(t2 - t1) * 1e3:.1f} ms = "
        f"{DECODE19 / (t2 - t1):.2f} tok/s; peak memory {peak:.2f} GiB")
    log(f"[19] launches a prefill chunk: { {k: n / chunks for k, n in got_pre.items()} }; a "
        f"decode step: { {k: n / DECODE19 for k, n in got_dec.items()} }; expected a chunk "
        f"A {per_a} (5 x {n_delta} + 7 x {n_attn} + 1), B {n_attn}, 9 {nl}, 10 {3 * nl}; a step "
        f"A {per_a}, C {n_attn}, 7 {nl}, 8 {nl}: {launch_ok}; logits finite {finite}: "
        f"{'ok' if ok else 'FAIL'}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE19, toks[:, -1:], tag="19", top=12,
                          host=False)
    moe_dec = kernel_ms(prof, "gate_up_i8_kernel", "down_i8_kernel")
    c_dec = kernel_ms(prof, "fa_decode_kernel<")
    log(f"[19] decode step: kernel A {a_ms(prof)}; kernel C {c_dec:.3f} ms; kernels 7 + 8 "
        f"{moe_dec:.3f} ms; all kernels {sum(prof.values()):.3f} ms")
    dn1 = delta_net_ms(torch, c, 1)
    dn512 = delta_net_ms(torch, c, 512, reps=2)
    step_ms = (t2 - t1) * 1e3 / DECODE19
    log(f"[19] the delta-net recurrence (ops/delta_net, plain PyTorch; {c['HV']} heads of "
        f"{c['DV']}x{c['DK']} f32 state) at T=1: {dn1[0]:.4f} ms of kernels in {dn1[1]} "
        f"launches, {dn1[2]:.3f} ms of host wall a call; over {n_delta} layers "
        f"{n_delta * dn1[0]:.3f} ms of kernels and {n_delta * dn1[2]:.2f} ms of wall, "
        f"{100 * n_delta * dn1[2] / step_ms:.1f}% of the {step_ms:.2f} ms decode step; at "
        f"T=512: {dn512[0]:.2f} ms of kernels in {dn512[1]} launches, {dn512[2]:.1f} ms wall a "
        f"call ({dn512[2] * 1e3 / 512:.1f} us a token), {n_delta * dn512[2]:.0f} ms a chunk")
    tail = ids[-512:]
    kv2 = rt.new_cache(1, PREFILL19 + 8)
    rt.eval_tokens(ids[:-512], kv2, 0)
    prof = profile_window(torch, lambda: rt.eval_tokens(tail, kv2, len(ids) - 512), 1,
                          f"the second prefill chunk (512 tokens at {len(ids) - 512} cached)",
                          "chunk", "19", top=12, host=False)
    k9 = kernel_ms(prof, "fused_prefill_i8_kernel")
    k10 = kernel_ms(prof, "ragged_i8_wgmma_kernel")
    log(f"[19] second prefill chunk: kernel A {a_ms(prof)}; kernel B (fa_prefill_kernel) "
        f"{kernel_ms(prof, 'fa_prefill_kernel'):.3f} ms; kernel 9 {k9:.3f} ms, kernel 10 "
        f"{k10:.3f} ms; all kernels {sum(prof.values()):.3f} ms")
    del kv, kv2, logits
    sizes = router_sizes(torch, rt, ids[:512], "_fused_prefill_try", 1)
    log_buckets(sizes, "19")
    replay.update(sizes=sizes, chunk_ms={"9": k9, "10": k10})
    torch.cuda.empty_cache()
    good, text = serve_interleaved(torch, rt, 191)
    log(f"[19] BatchEngine at L{nl}: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    good, text = recurrent_rollback(torch, rt)
    log(f"[19] speculative rollback at L{nl}: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    log(f"[19] Qwen3-Next-80B-A3B at L{nl}: {time.perf_counter() - t_phase:.1f} s")
    # one-history parity at depth 4: the file's three delta-net layers and
    # its attention layer
    rt.params["blocks"] = rt.params["blocks"][:4]
    rt.cfg = replace(rt.cfg, n_layer=4)
    torch.cuda.empty_cache()
    ok &= family_parity(torch, rt, 300, "Qwen3-Next-80B-A3B widths at depth 4", 192, "19")
    del rt
    torch.cuda.empty_cache()
    return ok


# ------------------------------------------ phases 20-21: speculative decoding --
class PlainHistory:
    """The one-history gate of phases 20 and 21: a run's prompt and tokens
    fed to the plain path at B = 1 in prefill chunks (``eval_tokens`` with
    every position's logits), so that the plain path sees the history the
    run emitted. Every emitted token must lie within 5% of the largest
    |logit| of the plain step's top logit; how many are its exact argmax is
    counted. Runs that emit the same tokens share one plain evaluation."""

    def __init__(self, torch, rt):
        self.torch, self.rt = torch, rt
        self.memo = {}          # (prompt, history) -> plain logits of each emitted token

    def logits(self, prompt: list, gen: list):
        key = (tuple(prompt), tuple(gen[:-1]))
        if key not in self.memo:
            seq = list(prompt) + list(gen[:-1])
            with plain_path():
                lg, _, _ = self.rt.eval_tokens(seq, self.rt.new_cache(1, len(seq) + 16), 0,
                                               all_logits=True)
            self.memo[key] = lg[len(prompt) - 1:]
        return self.memo[key]

    def verdict(self, prompt: list, gen: list):
        """(ok, text) of the one-history gate over ``gen``."""
        torch = self.torch
        lp = self.logits(prompt, gen)
        tok = torch.tensor(gen, device=lp.device)
        gap = lp.max(dim=1).values - lp.gather(1, tok[:, None])[:, 0]
        rel = gap / lp.abs().amax(dim=1)
        exact = int((lp.argmax(dim=1) == tok).sum())
        ok = bool((rel <= 5e-2).all()) and len(gen) > 0
        return ok, (f"{exact} of {len(gen)} emitted tokens the plain path's argmax; the "
                    f"largest gap to the plain step's top logit {100 * float(rel.max()):.2f}% "
                    f"of its largest |logit| (tol 5%)")


class WrongAt:
    """A drafter that proposes a known continuation with the token at
    position ``at`` of every proposal changed: each round accepts ``at``
    tokens at most."""

    def __init__(self, prompt_len: int, cont: list, at: int = 2):
        self.n0, self.cont, self.at = prompt_len, list(cont), at
        self.calls = []         # the history length at each proposal

    def propose(self, tokens, n_draft):
        self.calls.append(len(tokens))
        d = self.cont[len(tokens) - self.n0:][:n_draft]
        if len(d) > self.at:
            d[self.at] = (d[self.at] + 1) % 1000 + 3
        return d


def spec_prompt(rng, n: int, vocab: int, span: int = 128) -> list:
    """n random ids: a random span of ``span`` ids repeated, so that the
    n-gram drafters find matches in the prompt."""
    base = [int(x) for x in rng.integers(3, vocab, span)]
    return (base * (-(-n // span)))[:n]


def call_cost(torch, fn, what: str, tag: str) -> tuple:
    """One call of fn (a whole forward, host-bound): (the device ms of its
    kernels under torch.profiler, its wrapper launches by kernel). The
    profile's lines (wall, busy share, every kernel's launches, the top
    kernels) are logged."""
    fn()                                     # warm
    prof = profile_window(torch, fn, 1, what, "call", tag, top=4, host=False)
    reset_counts()
    fn()
    sync(torch)
    return sum(prof.values()), {k: n for k, n in read_counts().items() if n}


def verify_costs(torch, rt, kv, n_past: int, widths, tag: str, batch: int = 1) -> dict:
    """One verify forward (Runtime._spec_verify, T = W) at each width W over
    ``batch`` rows at n_past: {W: (device ms, wrapper launches by kernel)}."""
    out = {}
    for w in widths:
        step = rt._spec_verify(w)
        block = torch.randint(3, rt.cfg.n_vocab, (batch, w), device=rt.device)
        out[w] = call_cost(torch, lambda: step(block, kv, n_past),
                           f"a verify at B = {batch}, W = {w}", tag)
    return out


def wall_of(torch, fn):
    """fn() and its wall seconds around a synchronize."""
    sync(torch)
    t0 = time.perf_counter()
    res = fn()
    sync(torch)
    return res, time.perf_counter() - t0


def spec_line(tag: str, name: str, out: list, stats, secs: float, pre_s: float,
              device_ms: float, verdict) -> str:
    """A speculative run's figures: tok/s after the prefill, acceptance, the
    wall a round and the host's part of it, the one-history gate."""
    rounds = max(stats.n_rounds, 1)
    wall = (secs - pre_s) * 1e3 / rounds
    ok, text = verdict
    return (f"[{tag}] {name}: {len(out)} tokens, {len(out) / max(secs - pre_s, 1e-9):.2f} "
            f"tok/s after the prefill; {stats.n_rounds} rounds, {stats.n_accept} of "
            f"{stats.n_draft} drafts accepted ({100 * stats.accept_rate:.1f}%); "
            f"{wall:.2f} ms wall a round, {max(wall - device_ms, 0.0):.2f} ms of it the "
            f"host (the wall less {device_ms:.3f} ms of kernels a round); one "
            f"history: {text}: {'ok' if ok else 'FAIL'}")


def serve_spec(torch, rt, prompts: list, n_predict: int, spec) -> tuple:
    """Greedy requests on a 4-slot BatchEngine (speculative drafting
    ``spec``, or none), stepped in this thread: (tokens a request, seconds,
    engine)."""
    import queue
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
    eng = BatchEngine(rt, n_slots=len(prompts), capacity=1024, spec=spec, spec_n=8)
    reqs = []
    for p in prompts:
        r = Request(prompt_ids=p, n_predict=n_predict, sampler=SamplerParams(temp=0.0))
        r.stream_queue = queue.Queue()
        eng.submit(r)
        reqs.append(r)
    sync(torch)
    t0 = time.perf_counter()
    while eng.step():
        pass
    sync(torch)
    secs = time.perf_counter() - t0
    gens = []
    for r in reqs:
        toks = []
        while True:
            tok, _, done = r.stream_queue.get(timeout=0)
            if tok >= 0:
                toks.append(tok)
            if done:
                break
        gens.append(toks)
    return gens, secs, eng


def phase_spec(torch, gguf: Path, launches: dict, card: str) -> bool:
    """Phase 20: speculative decoding on the dense main path at full width
    (L32 of phase 4's file): a 512-token prompt and 64 new tokens, (a)
    plain greedy, (b) generate_speculative with ReplayDraft of (a)'s tokens
    at n_draft 4 and 8, (c) the ngram stage at 8, (d)
    generate_speculative_device (the device ngram table; replay), (e) a
    4-slot BatchEngine with spec="ngram", spec_n=8 against the same engine
    without spec, (f) one replay round over a q8 cache; every kernel launch
    of (a)-(f) counted. Each run passes the one-history gate; then verify
    ms and launches a round at each width."""
    from ik_llama_cpp_tpu_torch.runtime import speculative as SP
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t_phase = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=True), NL)
    rng = np.random.default_rng(20)
    ids = spec_prompt(rng, SPEC_PROMPT, V)
    cap = SPEC_PROMPT + SPEC_NEW + 32
    # warm-up: every verify width of the phase and the engine's block once
    for w in (5, 9):
        SP.generate_speculative(rt, ids[:64], 12, n_draft=w - 1, stop_at_eos=False,
                                stage=SP.ReplayDraft(64, [5] * 16), capacity=128)
    serve_spec(torch, rt, [ids[:64]] * 4, 4, "ngram")
    log(f"[20] loaded L{NL} and warmed the verify widths in "
        f"{time.perf_counter() - t_phase:.1f} s; prompt {len(ids)} tokens (a random span of "
        f"128 repeated), {SPEC_NEW} new tokens, greedy")
    ok = True
    runs = {}
    t_runs = time.perf_counter()
    reset_counts()
    (logits, toks, kv, n_past, pre_s, dec_s) = timed_run(torch, rt, ids, SPEC_NEW - 1)
    plain = [int(torch.argmax(logits[-1]))] + toks[0].tolist()
    del kv
    for n_draft in (4, 8):
        runs[f"(b) replay n_draft {n_draft}"] = wall_of(torch, lambda: SP.generate_speculative(
            rt, ids, SPEC_NEW, n_draft=n_draft, stop_at_eos=False, capacity=cap,
            stage=SP.ReplayDraft(len(ids), plain)))
    runs["(c) ngram n_draft 8"] = wall_of(torch, lambda: SP.generate_speculative(
        rt, ids, SPEC_NEW, n_draft=8, stop_at_eos=False, capacity=cap, stage="ngram"))
    runs["(d) device ngram n_draft 8"] = wall_of(torch, lambda: SP.generate_speculative_device(
        rt, ids, SPEC_NEW, n_draft=8, rounds_per_call=4, capacity=cap, stop_at_eos=False))
    runs["(d) device replay n_draft 8"] = wall_of(torch, lambda: SP.generate_speculative_device(
        rt, ids, SPEC_NEW, n_draft=8, rounds_per_call=4, capacity=cap, stop_at_eos=False,
        replay=plain))
    prompts = [spec_prompt(rng, 256, V, span=64) for _ in range(4)]
    spec_gens, spec_s, spec_eng = serve_spec(torch, rt, prompts, 48, "ngram")
    base_gens, base_s, base_eng = serve_spec(torch, rt, prompts, 48, None)
    rt8 = replace(rt, kv_quant="q8")
    q8_run = wall_of(torch, lambda: SP.generate_speculative(
        rt8, ids, 10, n_draft=8, stop_at_eos=False, capacity=cap,
        stage=SP.ReplayDraft(len(ids), plain)))
    sync(torch)
    counts = read_counts()
    for k in counts:
        launches[k] = launches.get(k, 0) + counts[k]
    path = ("qmatmul_i8", "flash_attention", "flash_attention_decode",
            "flash_attention_decode_q8", "flash_attention_q8")
    launched = all(counts[k] > 0 for k in path)
    others = {k: n for k, n in counts.items() if n and k not in path}
    ok &= launched and not others
    log(f"[20] launches of (a)-(f): { {k: counts[k] for k in path} }; other kernels {others}: "
        f"every kernel of the path launched: {'ok' if launched and not others else 'FAIL'}")

    # device ms and launches of one verify forward at each width (B = 1 at
    # the prompt's end; B = 4 rows of 9 as the engine runs them)
    t_costs = time.perf_counter()
    kv = rt.new_cache(1, cap)
    rt.eval_tokens(ids, kv, 0)
    costs = verify_costs(torch, rt, kv, len(ids), (1, 5, 9), "20")
    kv4 = rt.new_cache(4, cap)
    for r in range(4):
        rt.eval_tokens(ids, _row_view(kv4, r), 0)
    costs4 = verify_costs(torch, rt, kv4, len(ids), (9,), "20", batch=4)
    del kv4
    kv8 = rt8.new_cache(1, cap)
    rt8.eval_tokens(ids, kv8, 0)
    costs8 = verify_costs(torch, rt8, kv8, len(ids), (9,), "20")
    for w, (ms, n) in costs.items():
        log(f"[20] verify at B = 1, W = {w} at {len(ids)} cached: {ms:.3f} ms of kernels "
            f"(torch.profiler); wrapper launches {n}")
    log(f"[20] verify at B = 4, W = 9 (the engine's block: A at M = 36): "
        f"{costs4[9][0]:.3f} ms; wrapper launches {costs4[9][1]}")
    log(f"[20] verify over a q8 cache at W = 9: {costs8[9][0]:.3f} ms; wrapper launches "
        f"{costs8[9][1]}")
    del kv, kv8

    t_gates = time.perf_counter()
    gate = PlainHistory(torch, rt)
    v = gate.verdict(ids, plain)
    ok &= v[0]
    log(f"[20] on {card}: (a) plain greedy: prefill {len(ids)} tokens {pre_s * 1e3:.1f} ms, "
        f"decode {SPEC_NEW - 1} steps {dec_s * 1e3:.1f} ms = {(SPEC_NEW - 1) / dec_s:.2f} "
        f"tok/s; one history: {v[1]}: {'ok' if v[0] else 'FAIL'}")
    for name, ((_, out, stats), secs) in runs.items():
        w = 5 if "n_draft 4" in name else 9
        v = gate.verdict(ids, out)
        good = v[0] and len(out) == SPEC_NEW
        ok &= good
        log(spec_line("20", name, out, stats, secs, pre_s, costs[w][0], (good, v[1])))
    (_, out, stats), secs = q8_run
    gate8 = PlainHistory(torch, rt8)
    v = gate8.verdict(ids, out)
    ok &= v[0] and stats.n_rounds >= 1
    log(f"[20] (f) one replay round over a q8 cache (kernels 6 and 5): {len(out)} tokens, "
        f"{stats.n_accept} of {stats.n_draft} drafts accepted in {stats.n_rounds} round(s); "
        f"one history over the q8 cache: {v[1]}: {'ok' if v[0] else 'FAIL'}")
    texts, good_e = [], spec_eng.n_failed == 0 and base_eng.n_failed == 0
    for p, sg, bg in zip(prompts, spec_gens, base_gens):
        g = PlainHistory(torch, rt)
        vs, vb = g.verdict(p, sg), g.verdict(p, bg)
        good_e &= vs[0] and vb[0] and len(sg) > 0 and len(bg) > 0
        texts.append(f"spec tokens {'=' if sg == bg else '!='} plain engine's; spec: {vs[1]}; "
                     f"plain: {vb[1]}")
    ok &= good_e and spec_eng.n_spec_steps > 0
    n_spec, n_base = sum(map(len, spec_gens)), sum(map(len, base_gens))
    log(f"[20] (e) BatchEngine, 4 slots, 4 requests of 256 prompt tokens and 48 new: "
        f"spec ngram n 8: {n_spec / spec_s:.2f} tok/s over all slots in "
        f"{spec_eng.n_decode_steps} steps ({spec_eng.n_spec_steps} verify steps, "
        f"{spec_eng.n_draft_accepted} of {spec_eng.n_draft_proposed} drafts accepted); "
        f"without spec: {n_base / base_s:.2f} tok/s in {base_eng.n_decode_steps} steps: "
        + " | ".join(texts) + f": {'ok' if good_e else 'FAIL'}")
    log(f"[20] speculation on the dense path: {time.perf_counter() - t_phase:.1f} s (the runs "
        f"(a)-(f) {t_costs - t_runs:.1f} s, the verify profiles {t_gates - t_costs:.1f} s, the "
        f"one-history gates on the plain path {time.perf_counter() - t_gates:.1f} s)")
    del rt, rt8
    torch.cuda.empty_cache()
    return bool(ok)


def _row_view(kv, row: int):
    from ik_llama_cpp_tpu_torch.server.engine import cache_rows
    return cache_rows(kv, row)


def build_glm_gguf(path: Path, c: dict = GLM_AIR) -> Path:
    """GLM-4.5-Air at full width as glm4moe: the dense first layer, one MoE
    layer and the NextN/MTP layer (an MoE layer with eh_proj, enorm, hnorm
    and shared_head_norm), Q4_0 linears and experts with q/k/v biases, Q8_0
    embedding and untied head, f32 routers and selection biases, unit norms,
    random blocks from seed 0; cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=GLM_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    e, h, hkv, d, g, ff, v = (c[k] for k in ("E", "H", "HKV", "D", "G", "FF", "V"))
    arch = c["ARCH"]
    w = GGUFWriter(str(path), arch=arch)
    for key, val in (("block_count", 3), ("context_length", c["CTX"]),
                     ("embedding_length", e), ("feed_forward_length", c["FFD"]),
                     ("expert_feed_forward_length", ff), ("expert_count", g),
                     ("expert_used_count", c["TOPK"]), ("expert_shared_count", 1),
                     ("expert_shared_feed_forward_length", c["FFS"]),
                     ("leading_dense_block_count", 1), ("expert_gating_func", 2),
                     ("expert_weights_norm", True), ("expert_weights_scale", 1.0),
                     ("nextn_predict_layers", 1), ("attention.head_count", h),
                     ("attention.head_count_kv", hkv), ("attention.key_length", d),
                     ("attention.value_length", d),
                     ("attention.layer_norm_rms_epsilon", 1e-5),
                     ("rope.freq_base", c["ROPE"]), ("rope.dimension_count", c["ROPE_DIM"]),
                     ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, n=1):
        w.add_tensor(name, _rand_blocks(rng, n * rows, cols, ttype),
                     shape=(cols, rows) if n == 1 else (cols, rows, n), ggml_type=ttype)

    def f32(name, *shape, scale=1.0):
        w.add_tensor(name, (rng.standard_normal(shape) * scale).astype(np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    q("output.weight", v, e, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(e, np.float32))
    for i in range(3):
        p = f"blk.{i}."
        for name in ("attn_norm", "ffn_norm"):
            w.add_tensor(p + name + ".weight", np.ones(e, np.float32))
        q(p + "attn_q.weight", h * d, e)
        q(p + "attn_k.weight", hkv * d, e)
        q(p + "attn_v.weight", hkv * d, e)
        q(p + "attn_output.weight", e, h * d)
        for name, width in (("attn_q", h * d), ("attn_k", hkv * d), ("attn_v", hkv * d)):
            f32(p + name + ".bias", width, scale=0.1)
        if i == 0:
            q(p + "ffn_gate.weight", c["FFD"], e)
            q(p + "ffn_up.weight", c["FFD"], e)
            q(p + "ffn_down.weight", e, c["FFD"])
            continue
        f32(p + "ffn_gate_inp.weight", g, e, scale=1.0 / np.sqrt(e))
        f32(p + "exp_probs_b.bias", g, scale=0.1)
        q(p + "ffn_gate_exps.weight", ff, e, n=g)
        q(p + "ffn_up_exps.weight", ff, e, n=g)
        q(p + "ffn_down_exps.weight", e, ff, n=g)
        q(p + "ffn_gate_shexp.weight", c["FFS"], e)
        q(p + "ffn_up_shexp.weight", c["FFS"], e)
        q(p + "ffn_down_shexp.weight", e, c["FFS"])
        if i == 2:
            q(p + "nextn.eh_proj.weight", e, 2 * e)
            for name in ("enorm", "hnorm", "shared_head_norm"):
                w.add_tensor(p + f"nextn.{name}.weight", np.ones(e, np.float32))
    w.write()
    mpath.write_text(meta)
    return path


def phase_mtp(torch, launches: dict, card: str) -> bool:
    """Phase 21: the NextN/MTP layer at GLM-4.5-Air's width: the dense first
    layer, LRUN - 1 MoE layers (block 1 of the file cloned) and the MTP
    layer; a 512-token prompt and 48 new tokens, plain greedy and
    generate_speculative(stage="mtp") at n_draft 3 (W 4) and 8 (W 9), and
    at 3 with the drafts forced to the plain continuation (accepted rows
    refreshed, the refreshed MTP cache rows checked), every kernel launch
    counted, each run through the one-history gate; then verify ms and
    launches at both widths and the MTP draft step's, and the MTP layer's
    logits and hidden against the plain path."""
    from ik_llama_cpp_tpu_torch.models.llama import mtp_forward
    from ik_llama_cpp_tpu_torch.runtime import speculative as SP
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    c = GLM_AIR
    nl = c["LRUN"]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gguf = build_glm_gguf(ROOT / "build" / "smoke_glm45air.gguf", c)
    file_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = Runtime.from_gguf(gguf)
    two = rt.params["blocks"]
    rt.params["blocks"] = two + [copy.deepcopy(two[1]) for _ in range(2, nl)]
    rt.cfg = replace(rt.cfg, n_layer=nl)
    sync(torch)
    load_s = time.perf_counter() - t0
    blk, mtp = rt.params["blocks"][1], rt.params["mtp_blocks"][0]
    ex = blk["experts"]
    kinds = {k: type(blk[k]).__name__ for k in ("wq", "wo", "ffn_gate_shexp", "ffn_down_shexp")}
    kinds.update(dense_down=type(rt.params["blocks"][0]["ffn_down"]).__name__,
                 eh_proj=type(mtp["eh_proj"]).__name__)
    log(f"[21] glm4moe L{nl} (1 dense, {nl - 1} MoE) + the MTP layer, E{c['E']} H{c['H']} "
        f"KV{c['HKV']} D{c['D']} rope {c['ROPE_DIM']} dims, dense FF{c['FFD']}, G{c['G']} "
        f"top-{c['TOPK']} FF{c['FF']} + shared FF{c['FFS']}, V{c['V']}: file ready in "
        f"{file_s:.1f} s, loaded and cloned in {load_s:.1f} s; experts group "
        f"{ex.gate_group} / {ex.up_group} / {ex.down_group} (FF {c['FF']} is not a multiple "
        f"of 256: the down experts stay planar); linears {kinds}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(21)
    ids = [int(x) for x in rng.integers(3, c["V"], GLM_PROMPT)]
    cap = GLM_PROMPT + GLM_NEW + 32
    for n_draft in (3, 8):        # warm-up of every width
        SP.generate_speculative(rt, ids[:64], 6, n_draft=n_draft, stop_at_eos=False,
                                stage="mtp", capacity=128)
    ok = True
    reset_counts()
    (logits, toks, kv, n_past, pre_s, dec_s) = timed_run(torch, rt, ids, GLM_NEW - 1)
    plain = [int(torch.argmax(logits[-1]))] + toks[0].tolist()
    del kv
    runs = {}
    for n_draft in (3, 8):
        runs[f"mtp n_draft {n_draft}"] = wall_of(torch, lambda: SP.generate_speculative(
            rt, ids, GLM_NEW, n_draft=n_draft, stop_at_eos=False, capacity=cap, stage="mtp"))
    # random weights' drafts are not accepted: a run with the draft step's
    # pick forced to the plain continuation refreshes accepted rows
    forced, forced_ok, forced_text = forced_mtp_run(torch, rt, ids, plain, GLM_NEW, cap)
    sync(torch)
    counts = read_counts()
    for k in counts:
        launches[k] = launches.get(k, 0) + counts[k]
    # the int8 path's linears (A), the planar dense and shared-expert downs
    # (D: K 10944 and 1408), B and C, and the mixed MoE path: kernels 12 and
    # 13 at T <= 8, 10 and 14 above
    path = ("qmatmul_i8", "qmatmul", "flash_attention", "flash_attention_decode",
            "moe_decode_gate_up", "moe_decode_down", "ragged_qmatmul_i8", "ragged_qmatmul")
    launched = all(counts[k] > 0 for k in path)
    others = {k: n for k, n in counts.items() if n and k not in path
              and k not in ("qmatmul_wgmma", "ragged_qmatmul_wgmma")}
    ok &= launched and not others
    log(f"[21] launches of the three runs: { {k: counts[k] for k in path} } (the wgmma forms: "
        f"D {counts['qmatmul_wgmma']}, 14 {counts['ragged_qmatmul_wgmma']}); other kernels "
        f"{others}: every kernel of the path launched: "
        f"{'ok' if launched and not others else 'FAIL'}")

    kv = rt.new_cache(1, cap)
    _, hid, kv, _ = rt.eval_tokens_hidden(ids, kv, 0)
    # the MTP loop verifies through eval_tokens_hidden: W = 4 padded to a
    # chunk of 8 rows, W = 9 to 16 (the JAX runtime's buckets), beside one
    # plain decode step
    tok = torch.tensor([[ids[-1]]], device=rt.device)
    costs = {w: call_cost(torch, lambda: rt.eval_tokens_hidden(ids[-w:], kv, len(ids)),
                          f"a verify of W = {w} (eval_tokens_hidden)", "21") for w in (4, 9)}
    costs[1] = call_cost(torch, lambda: llama_step(torch, rt, tok, kv, len(ids)),
                         "a decode step", "21")
    mkv = rt.new_mtp_cache(1, cap)
    h1 = hid[-1].reshape(1, 1, -1)
    step_ms, step_n = call_cost(
        torch, lambda: mtp_forward(rt.params, rt.cfg, tok, h1, mkv, len(ids) - 1),
        "an MTP draft step", "21")
    hid8 = hid[-8:]
    ref_ms, _ = call_cost(torch, lambda: rt.mtp_eval(ids[-8:], hid8, mkv, len(ids) - 8),
                          "an MTP refresh (mtp_eval, 8 rows)", "21")
    del kv, mkv
    good, text = mtp_parity(torch, rt, ids, hid, plain[0])
    ok &= good
    log(f"[21] the MTP layer, kernel path against plain path on the same main hiddens: {text}: "
        f"{'ok' if good else 'FAIL'}")
    del hid
    for w, (ms, n) in sorted(costs.items()):
        log(f"[21] verify of W = {w} at {len(ids)} cached "
            f"({'one decode step' if w == 1 else 'padded to %d rows' % (8 if w <= 8 else 16)}): "
            f"{ms:.3f} ms of kernels (torch.profiler); wrapper launches {n}")
    log(f"[21] the MTP draft step (T = 1: eh_proj, attention, MoE, the head): {step_ms:.3f} ms "
        f"of kernels; wrapper launches {step_n}; the refresh of accepted rows (mtp_eval, padded "
        f"to 8 rows): {ref_ms:.3f} ms")
    gate = PlainHistory(torch, rt)
    v = gate.verdict(ids, plain)
    ok &= v[0]
    log(f"[21] on {card}: plain greedy: prefill {len(ids)} tokens {pre_s * 1e3:.1f} ms, decode "
        f"{GLM_NEW - 1} steps {dec_s * 1e3:.1f} ms = {(GLM_NEW - 1) / dec_s:.2f} tok/s; one "
        f"history: {v[1]}: {'ok' if v[0] else 'FAIL'}")
    for name, ((_, out, stats), secs) in runs.items():
        n_draft = int(name.split()[-1])
        v = gate.verdict(ids, out)
        good = v[0] and len(out) == GLM_NEW
        ok &= good
        # a round's device time: the drafts' MTP steps, the verify, one refresh
        dev_ms = n_draft * step_ms + costs[1 + n_draft][0] + ref_ms
        log(spec_line("21", name, out, stats, secs, pre_s, dev_ms, (good, v[1]))
            + f" (device time a round: {n_draft} MTP steps + the verify at W = "
              f"{1 + n_draft} + one refresh)")
    (_, out, stats), secs = forced
    v = gate.verdict(ids, out)
    good = v[0] and len(out) == GLM_NEW and forced_ok
    ok &= good
    log(spec_line("21", "mtp n_draft 3, drafts forced to the plain continuation", out, stats,
                  secs, pre_s, 3 * step_ms + costs[4][0] + ref_ms, (good, v[1]))
        + f"; {forced_text}")
    log(f"[21] GLM-4.5-Air's MTP at L{nl}: {time.perf_counter() - t_phase:.1f} s")
    del rt
    torch.cuda.empty_cache()
    return bool(ok)


def mtp_parity(torch, rt, ids: list, hid, first: int):
    """The MTP layer's numbers, kernel path against plain path on the same
    main hiddens ``hid`` (n, E) of the prompt ``ids``: its warm-up over the
    prompt (rows 0 .. n - 2), a draft step at T = 1 (row n - 1, the first
    generated token ``first``) and a refresh of rows n - 7 .. n - 4
    (mtp_eval). Each one's logits and MTP hidden must lie within 5% of the
    plain path's largest |value| (the rule of phase 5). Returns (ok, text)."""
    from ik_llama_cpp_tpu_torch.models.llama import mtp_forward
    n = len(ids)
    tok = torch.tensor([[first]], device=rt.device)

    def run():
        mkv = rt.new_mtp_cache(1, n + 32)
        lw, hw, mkv, _ = rt.mtp_eval(ids[1:], hid[:-1], mkv, 0)
        ld, mkv, hd = mtp_forward(rt.params, rt.cfg, tok, hid[-1].reshape(1, 1, -1), mkv, n - 1)
        lr, hr, mkv, _ = rt.mtp_eval(ids[-6:-2], hid[-7:-3], mkv, n - 7)
        return {"warm-up": (lw, hw), "draft step": (ld[0, 0], hd[0, 0]), "refresh": (lr, hr)}

    mine = run()
    with plain_path():
        want = run()
    ok, parts = True, []
    for what, pair in mine.items():
        errs = []
        for got, ref in zip(pair, want[what]):
            e, m = float((got - ref).abs().max()), float(ref.abs().max())
            ok &= e <= 5e-2 * m
            errs.append(f"{e:.3e} of max {m:.3f}")
        parts.append(f"{what}: logits {errs[0]}, hidden {errs[1]}")
    return ok, "; ".join(parts) + " (tol 5% of each max)"


@contextmanager
def forced_mtp_drafts(torch, seq: list, seen: dict):
    """mtp_forward with the draft step's logits replaced by a one-hot of
    the token its row predicts in ``seq`` (row p predicts seq[p + 2]),
    changed at every third row, so that MTP rounds accept 0-2 drafts. The
    layer itself still runs on its kernels, and its cache and hidden stream
    are kept; ``seen`` gets the cache and the first row of the last refresh
    (a call of more than one row)."""
    from ik_llama_cpp_tpu_torch.models import llama
    real = llama.mtp_forward

    def forward(params, cfg, tokens, hidden, kv, n_past):
        lg, kv, h = real(params, cfg, tokens, hidden, kv, n_past)
        seen["kv"] = kv
        if tokens.shape[1] > 1:
            seen["refresh"] = int(n_past)
            return lg, kv, h
        p = int(n_past) + 2
        tok = (seq[p] if p < len(seq) else 0) + (1 if p % 3 == 0 else 0)
        one = torch.full_like(lg, -1e4)
        one[..., tok % lg.shape[-1]] = 0.0
        return one, kv, h

    llama.mtp_forward = forward
    try:
        yield
    finally:
        llama.mtp_forward = real


def forced_mtp_run(torch, rt, ids: list, plain: list, n_new: int, cap: int):
    """generate_speculative(stage="mtp", n_draft 3) with drafts forced to
    the plain continuation (forced_mtp_drafts), so that accepted rows are
    refreshed: (the run's (ids, tokens, stats) and wall seconds, ok, text).
    The MTP cache rows that the refreshes left, [0, the last refresh's
    first row], must match one fresh mtp_eval over the main hiddens of one
    prefill of the same tokens, within 5% of their largest |value| (the
    hiddens of a verify chunk and of a prefill differ by the kernels' bf16
    and int8 rounding)."""
    from ik_llama_cpp_tpu_torch.runtime import speculative as SP
    seen = {}
    with forced_mtp_drafts(torch, list(ids) + list(plain), seen):
        run = wall_of(torch, lambda: SP.generate_speculative(
            rt, ids, n_new, n_draft=3, stop_at_eos=False, capacity=cap, stage="mtp"))
    (_, out, stats), _ = run
    seq = list(ids) + list(out)
    n = seen["refresh"] + 1
    kv = rt.new_cache(1, cap)
    _, hid, kv, _ = rt.eval_tokens_hidden(seq[:n], kv, 0)
    fresh = rt.new_mtp_cache(1, cap)
    rt.mtp_eval(seq[1:n + 1], hid, fresh, 0)
    ok = 0 < stats.n_accept < stats.n_draft
    errs = []
    for f in ("k", "v"):
        got = getattr(seen["kv"], f)[0, 0, :n].float()
        want = getattr(fresh, f)[0, 0, :n].float()
        e, m = float((got - want).abs().max()), float(want.abs().max())
        ok &= e <= 5e-2 * m
        errs.append(f"{f} {e:.3e} of max {m:.3f}")
    del kv, hid, fresh
    return run, ok, (f"{stats.n_accept} of {stats.n_draft} forced drafts accepted in "
                     f"{stats.n_rounds} rounds; the MTP cache's {n} refreshed rows against one "
                     f"fresh mtp_eval: max_abs_err " + ", ".join(errs) + " (tol 5% of each max)")


def recurrent_rollback(torch, rt, seed: int = 193, n_prompt: int = 256, n_new: int = 12):
    """Phases 19's and 22's speculative check: generate_speculative's host
    loop on a loaded recurrent model with a drafter wrong at the third
    token of every proposal, so each round accepts in part and restores
    the conv tails and recurrent states it cloned before the verify. Its state must equal a
    plain run's over the accepted tokens in the same chunks (the prompt,
    then each round's accepted block) to 1e-5 of the largest value; the
    error to one unchunked evaluation is printed beside. Returns (ok,
    text)."""
    from ik_llama_cpp_tpu_torch.runtime import speculative as SP
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(3, rt.cfg.n_vocab, n_prompt)]
    cap = n_prompt + 64
    _, plain = rt.generate_greedy_on_device(ids, n_new, stop_at_eos=False)
    drafter = WrongAt(len(ids), plain)
    stats = SP.SpecStats()
    (out, kv, n_past), secs = wall_of(torch, lambda: SP._generate_spec_host(
        rt, ids, n_new, draft=None, n_draft=4, sampler=SamplerParams(temp=0.0),
        rng=np.random.default_rng(0), capacity=cap, stop_at_eos=False, stats=stats,
        drafter=drafter))
    fed = n_past - len(ids)
    # the rounds' blocks: from each proposal's history length to the next
    bounds = [n - len(ids) - 1 for n in drafter.calls] + [fed]
    ref = rt.new_cache(1, cap)
    _, ref, n = rt.eval_tokens(ids, ref, 0)
    for a, b in zip(bounds, bounds[1:]):
        _, ref, n = rt.eval_tokens(out[a:b], ref, n)
    one = rt.new_cache(1, cap)
    rt.eval_tokens(ids + out[:fed], one, 0)
    errs = {}
    for f in (f for f in type(kv).ROW_FIELDS if f not in ("k", "v")):
        mine, want = getattr(kv, f), getattr(ref, f)
        errs[f] = (float((mine - want).abs().max()), float(want.abs().max()),
                   float((mine - getattr(one, f)).abs().max()))
    ok = n == n_past and all(e <= 1e-5 * m for e, m, _ in errs.values())
    ok &= 0 < stats.n_accept < stats.n_draft
    clone_ms = event_ms(torch, lambda: kv.checkpoint())
    nbytes = sum(t.numel() * t.element_size() for t in kv.checkpoint())
    good, text = replay_verdict(torch, rt, ids, out, step_by_step=True)
    ok &= good
    del kv, ref, one
    return ok, (f"{len(out)} tokens in {stats.n_rounds} rounds, {stats.n_accept} of "
                f"{stats.n_draft} drafts accepted, {secs:.2f} s; state after the last "
                f"rollback against the same chunks evaluated plainly: max_abs_err "
                + ", ".join(f"{f} {e:.3e} of max {m:.3f} (tol 1e-5 of it; against one "
                            f"unchunked evaluation {u:.3e})" for f, (e, m, u) in errs.items())
                + f"; the checkpoint clone: {nbytes / 2**20:.1f} MiB in {clone_ms:.4f} ms "
                f"(CUDA events); step-by-step replay: {text}")


# ------------------------------------------- phases 22-23: mamba, LoRA, perplexity --
def build_mamba_gguf(path: Path, c: dict = MAMBA) -> Path:
    """One block of Mamba at the width ``c``, quantized as llama.cpp's
    quantizer leaves such a model (it does not quantize Mamba's small 2D
    weights): Q4_0 ssm_in / ssm_out, a Q8_0 tied token_embd, and float32
    conv kernel and bias, ssm_x, ssm_dt and its bias, A, D and norms.
    Mamba's initialization from seed 0: A = -(1 .. state) on every row
    (A_log = log(1 .. 16)), D = 1, the dt bias the inverse softplus of a dt
    drawn log-uniform in [1e-3, 0.1], the conv kernel and bias uniform in
    +-1/sqrt(conv), ssm_x and ssm_dt at 1/sqrt(fan-in). Cached beside a
    .meta; the block clones to any depth (clone_layers)."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=MAMBA_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, e, di, ds, dtr, v = c["ARCH"], c["E"], c["DI"], c["DS"], c["DTR"], c["V"]
    w = GGUFWriter(str(path), arch=arch)
    for key, val in (("block_count", 1), ("context_length", 1 << 20),
                     ("embedding_length", e), ("feed_forward_length", 0),
                     ("attention.head_count", 0), ("attention.head_count_kv", 0),
                     ("attention.layer_norm_rms_epsilon", c["EPS"]),
                     ("ssm.conv_kernel", c["CONV"]), ("ssm.inner_size", di),
                     ("ssm.state_size", ds), ("ssm.time_step_rank", dtr), ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(v)])
    w.add("tokenizer.ggml.token_type", np.ones(v, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 0)

    def q(name, rows, cols, ttype=GGMLType.Q4_0):
        w.add_tensor(name, _rand_blocks(rng, rows, cols, ttype), shape=(cols, rows),
                     ggml_type=ttype)

    def f32(name, a):
        w.add_tensor(name, np.ascontiguousarray(a, dtype=np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    f32("output_norm.weight", np.ones(e))
    p = "blk.0."
    f32(p + "attn_norm.weight", np.ones(e))
    q(p + "ssm_in.weight", 2 * di, e)
    bound = 1.0 / np.sqrt(c["CONV"])
    f32(p + "ssm_conv1d.weight", rng.uniform(-bound, bound, (di, c["CONV"])))
    f32(p + "ssm_conv1d.bias", rng.uniform(-bound, bound, di))
    f32(p + "ssm_x.weight", rng.standard_normal((dtr + 2 * ds, di)) / np.sqrt(di))
    f32(p + "ssm_dt.weight", rng.uniform(-1.0, 1.0, (di, dtr)) / np.sqrt(dtr))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), di))
    f32(p + "ssm_dt.bias", dt + np.log(-np.expm1(-dt)))
    f32(p + "ssm_a", -np.tile(np.arange(1, ds + 1), (di, 1)))
    f32(p + "ssm_d", np.ones(di))
    q(p + "ssm_out.weight", e, di)
    w.write()
    mpath.write_text(meta)
    return path


def load_mamba(torch, c: dict, n_layer: int, device="cuda"):
    """c's one-block file built (or found) under build/, loaded through
    Runtime.from_gguf and cloned into n_layer distinct device blocks.
    Returns (runtime, file s, load s)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    t0 = time.perf_counter()
    gguf = build_mamba_gguf(ROOT / "build" / "smoke_mamba.gguf", c)
    t1 = time.perf_counter()
    rt = clone_layers(Runtime.from_gguf(gguf, device), n_layer)
    sync(torch)
    return rt, t1 - t0, time.perf_counter() - t1


def scan_ms(torch, c: dict, t: int) -> tuple:
    """One layer's selective scan alone at T tokens on the card, every
    position live: (the host's wall ms a call around a synchronize; one
    call's device ms by CUDA events, enqueued behind a ~50 ms device sleep
    that covers its launches)."""
    from ik_llama_cpp_tpu_torch.models.mamba import _selective_scan
    gen = torch.Generator(device="cuda").manual_seed(22)
    di, ds = c["DI"], c["DS"]
    x = torch.randn((1, t, di), generator=gen, device="cuda")
    dt = torch.randn((1, t, di), generator=gen, device="cuda") - 4.0
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").repeat(di, 1)
    b = torch.randn((1, t, ds), generator=gen, device="cuda")
    cc = torch.randn((1, t, ds), generator=gen, device="cuda")
    state = torch.zeros((1, di, ds), device="cuda")

    def call():
        return _selective_scan(x, dt, a, b, cc, state, None)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    s.record()
    call()
    e.record()
    e.synchronize()
    return host, s.elapsed_time(e)


def range_ms(torch, fn, name: str) -> tuple:
    """fn run once under torch.profiler with host and device activity: the
    record_function range ``name``'s calls, its host ms a call and the
    device ms a call of the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.key == name and e.device_type == DeviceType.CPU]
    n = sum(e.count for e in rows)
    host = sum(e.cpu_time_total for e in rows) / 1e3
    dev = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
              for e in rows) / 1e3
    return n, host / max(n, 1), dev / max(n, 1)


def held_to(torch, rt, prompt: list, got: list, want: list) -> tuple:
    """(ok, text): ``got`` equals the runtime's greedy tokens ``want``, or
    parts from them at a near-tie: where they first differ, the runtime's
    top-2 logits (one evaluation of the prompt and want's tokens before that
    step) lie within 1% of its largest |logit|."""
    if got == want:
        return True, f"all {len(got)} tokens the runtime's greedy tokens"
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    if i >= min(len(got), len(want)):
        return False, f"{len(got)} tokens against the runtime's {len(want)}"
    seq = prompt + want[:i]
    lg = rt.eval_tokens(seq, rt.new_cache(1, len(seq) + 16), 0)[0][-1]
    top2 = lg.topk(2).values
    gap = float(top2[0] - top2[1]) / float(lg.abs().max())
    return gap <= 1e-2, (f"the runtime's greedy tokens up to step {i} of {len(want)}, where "
                         f"its top-2 gap is {100 * gap:.3f}% of its largest |logit| "
                         f"(a near-tie below 1%)")


def padded_state(torch, rt, seed: int, n_live: int = 13, n_prefix: int = 64) -> tuple:
    """A chunk of n_live tokens after an n_prefix-token prefix, evaluated
    unpadded, padded with zeros to a 16-token bucket at n_valid n_live, and
    padded with other tokens at n_valid n_live: the three conv tails and
    scan states bit for bit (and without n_valid the padding reaches the
    state). Returns (ok, text)."""
    from ik_llama_cpp_tpu_torch.runtime.generate import FORWARDS
    fwd = FORWARDS[rt.cfg.arch]
    rng = np.random.default_rng(seed)
    v = rt.cfg.n_vocab
    prefix = torch.tensor([[int(x) for x in rng.integers(3, v, n_prefix)]], device=rt.device)
    live = [int(x) for x in rng.integers(3, v, n_live)]
    other = [int(x) for x in rng.integers(3, v, 16 - n_live)]
    kvs = [rt.new_cache(1, 64) for _ in range(4)]
    for kv in kvs:
        fwd(rt.params, rt.cfg, prefix, kv, 0)
    same_prefix = all(torch.equal(k.ssm, kvs[0].ssm) for k in kvs[1:])
    for kv, (toks, nv) in zip(kvs, ((live, None), (live + [0] * (16 - n_live), n_live),
                                    (live + other, n_live), (live + other, None))):
        fwd(rt.params, rt.cfg, torch.tensor([toks], device=rt.device), kv, n_prefix, n_valid=nv)
    a, b, c, d = kvs
    pad_same = torch.equal(b.conv, c.conv) and torch.equal(b.ssm, c.ssm)
    unpadded_same = torch.equal(a.conv, b.conv) and torch.equal(a.ssm, b.ssm)
    err = max(float((a.ssm - b.ssm).abs().max()), float((a.conv - b.conv).abs().max()))
    reached = float((d.ssm - a.ssm).abs().max())
    ok = same_prefix and pad_same and unpadded_same and reached > 0
    return ok, (f"{n_live} live tokens of a 16-token bucket after a {n_prefix}-token prefix "
                f"(the prefix's state bit for bit the same in four caches: {same_prefix}): "
                f"state bit for bit the unpadded chunk's: {unpadded_same} (max_abs_err "
                f"{err:.3e}); whatever the padding: {pad_same}; without n_valid the padding "
                f"moves the state by {reached:.3e}")


def serve_two_greedy(torch, rt, seed: int, n_predict: int = 16) -> tuple:
    """Two greedy requests (120 and 600 tokens, the second two prefill
    chunks) on a 2-slot BatchEngine stepped in this thread, each held to
    the runtime's greedy tokens for its prompt alone (held_to). Returns
    (ok, text)."""
    import queue
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(3, rt.cfg.n_vocab, n)] for n in (120, 600)]
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    reqs = []
    t0 = time.perf_counter()
    for p in prompts:
        r = Request(prompt_ids=p, n_predict=n_predict, sampler=SamplerParams(temp=0.0))
        r.stream_queue = queue.Queue()
        eng.submit(r)
        reqs.append(r)
    while eng.step():
        pass
    wall = time.perf_counter() - t0
    ok, texts, n_tok = eng.n_failed == 0, [], 0
    for p, r in zip(prompts, reqs):
        got = []
        while True:
            tok, _, done = r.stream_queue.get(timeout=0)
            if tok >= 0:
                got.append(tok)
            if done:
                break
        n_tok += len(got)
        want = rt.generate_greedy_on_device(p, n_predict)[1]
        good, text = held_to(torch, rt, p, got, want)
        ok &= good
        texts.append(f"{len(p)}-token prompt: {text}")
    del eng
    return ok, (f"2 requests in {wall:.2f} s ({n_tok / wall:.1f} tok/s over both slots): "
                + " | ".join(texts))


def phase_mamba(torch, launches: dict, card: str) -> bool:
    """Phase 22: the mamba family. Mamba-2.8B at full width, L22 of its 64
    layers, on
    the recurrent MambaCache: the load, a 512-token prefill and 64 greedy
    decode steps with every kernel launch counted, decode and prefill
    profiles, the scan's device and host ms a layer, a one-history parity,
    a padded chunk's state, two requests on a 2-slot BatchEngine and
    generate_speculative (a replay draft; a drafter wrong at its third
    token)."""
    from ik_llama_cpp_tpu_torch.runtime import speculative as SP
    c = MAMBA
    nl = L22
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rt, file_s, load_s = load_mamba(torch, c, nl)
    kinds = sorted(set(_linear_kinds(rt)) | {type(rt.params["output"]).__name__})
    probe = rt.new_cache(1)
    row_mib = sum(t.numel() * t.element_size() for t in (probe.conv, probe.ssm)) / 2**20
    log(f"[22] mamba L{nl} E{c['E']} d_inner {c['DI']} state {c['DS']} conv {c['CONV']} dt rank "
        f"{c['DTR']} V{c['V']} tied: file ready in {file_s:.1f} s, loaded and cloned in "
        f"{load_s:.1f} s; linears {kinds}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; state {row_mib:.2f} MiB a row")
    rng = np.random.default_rng(22)
    rt.eval_tokens([int(x) for x in rng.integers(3, c["V"], 8)], rt.new_cache(1), 0)
    ids = [int(x) for x in rng.integers(3, c["V"], PREFILL)]
    kv = rt.new_cache(1)
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    sync(torch)
    t1 = time.perf_counter()
    counts_pre = read_counts()
    reset_counts()
    toks = rt._decode_loop(first, kv, n_past, DECODE)
    sync(torch)
    t2 = time.perf_counter()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in counts:
        launches[k] = launches.get(k, 0) + counts_pre[k] + counts[k]
    per_a = 2 * nl + 1                    # ssm_in and ssm_out a layer, the head
    got_pre = {k: n for k, n in counts_pre.items() if n}
    got_dec = {k: n for k, n in counts.items() if n}
    launch_ok = got_pre == {"qmatmul_i8": per_a} and got_dec == {"qmatmul_i8": per_a * DECODE}
    finite = bool(torch.isfinite(logits).all())
    ok = launch_ok and finite and bool(((toks >= 0) & (toks < c["V"])).all())
    log(f"[22] on {card}: prefill {len(ids)} tokens: {(t1 - t0) * 1e3:.1f} ms = "
        f"{len(ids) / (t1 - t0):.1f} tok/s; decode {DECODE} tokens: {(t2 - t1) * 1e3:.1f} ms = "
        f"{DECODE / (t2 - t1):.2f} tok/s; peak memory {peak:.2f} GiB")
    log(f"[22] launches the prefill chunk: {got_pre}; a decode step: "
        f"{ {k: n / DECODE for k, n in got_dec.items()} }; expected A {per_a} (2 x {nl} + 1) "
        f"a chunk and a step and nothing else: {launch_ok}; logits finite {finite}: "
        f"{'ok' if ok else 'FAIL'}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE, toks[:, -1:], tag="22", top=10,
                          host=False)
    log(f"[22] decode step: kernel A {a_ms(prof)}; all kernels {sum(prof.values()):.3f} ms "
        f"of the {(t2 - t1) * 1e3 / DECODE:.2f} ms step")
    n1, host1, dev1 = range_ms(
        torch, lambda: rt._decode_loop(toks[:, -1:], kv, n_past + DECODE, 1), "mamba.scan")
    host512, dev512 = scan_ms(torch, c, PREFILL)
    log(f"[22] the selective scan (models/mamba._selective_scan, plain PyTorch; {c['DI']} x "
        f"{c['DS']} f32 state a layer, one launch a token): its mamba.scan range in a "
        f"profiled decode step {n1} calls, {host1:.3f} ms of host and {dev1:.4f} ms of device "
        f"a layer, {nl * host1:.1f} ms of host over {nl} layers; alone at T={PREFILL} "
        f"{host512:.1f} ms of host wall and {dev512:.3f} ms of device a layer "
        f"({host512 * 1e3 / PREFILL:.1f} us a token), {nl * host512:.0f} ms of host a chunk")
    kv2 = rt.new_cache(1)
    prof = profile_window(torch, lambda: rt.eval_tokens(ids, kv2, 0), 1,
                          f"one {PREFILL}-token prefill chunk", "chunk", "22", top=10,
                          host=False)
    log(f"[22] prefill chunk: kernel A {a_ms(prof)}; all kernels {sum(prof.values()):.3f} ms")
    del kv, kv2, logits, probe
    torch.cuda.empty_cache()
    ok &= family_parity(torch, rt, PREFILL, f"Mamba-2.8B at L{nl}", 221, "22")
    good, text = padded_state(torch, rt, 222)
    log(f"[22] padded chunk: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    good, text = serve_two_greedy(torch, rt, 223)
    log(f"[22] BatchEngine at L{nl}: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    ids = [int(x) for x in np.random.default_rng(224).integers(3, c["V"], 256)]
    n_new = 16
    _, plain = rt.generate_greedy_on_device(ids, n_new, stop_at_eos=False)
    (_, out, st), secs = wall_of(torch, lambda: SP.generate_speculative(
        rt, ids, n_new, n_draft=8, stop_at_eos=False, stage=SP.ReplayDraft(len(ids), plain)))
    good, text = held_to(torch, rt, ids, out, plain)
    log(f"[22] generate_speculative with a replay draft (n_draft 8, the host loop with its "
        f"checkpoint): {len(out)} tokens in {secs:.2f} s, {st.n_rounds} rounds, {st.n_accept} "
        f"of {st.n_draft} drafts accepted; {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    good, text = recurrent_rollback(torch, rt, seed=225)
    log(f"[22] speculative rollback at L{nl}: {text}: {'ok' if good else 'FAIL'}")
    ok &= good
    log(f"[22] Mamba-2.8B at L{nl}: {time.perf_counter() - t_phase:.1f} s")
    del rt
    torch.cuda.empty_cache()
    return ok


def build_lora_gguf(path: Path, n_layer: int) -> Path:
    """A LoRA adapter for the dense model of phase 4 at depth n_layer: rank
    LORA_RANK, alpha LORA_ALPHA, float32 lora_a / lora_b on all seven
    projections of every layer, written by runtime/lora.write_lora_gguf;
    A ~ N(0, 1/n_in) and B ~ N(0, 0.02^2) from seed 23 (PEFT starts B at
    zero; a trained adapter's is not). Cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.runtime.lora import write_lora_gguf
    meta = json.dumps(dict(v="port-23", L=n_layer, E=E, HKV=HKV, D=D, FF=FF, r=LORA_RANK,
                           alpha=LORA_ALPHA))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(23)
    dims = {"attn_q": (E, E), "attn_k": (E, HKV * D), "attn_v": (E, HKV * D),
            "attn_output": (E, E), "ffn_gate": (E, FF), "ffn_up": (E, FF), "ffn_down": (FF, E)}
    tensors = {}
    for i in range(n_layer):
        for name, (k, n) in dims.items():
            a = rng.standard_normal((LORA_RANK, k), dtype=np.float32) / np.float32(np.sqrt(k))
            b = rng.standard_normal((n, LORA_RANK), dtype=np.float32) * np.float32(0.02)
            tensors[f"blk.{i}.{name}.weight"] = (a, b)
    write_lora_gguf(path, "llama", LORA_ALPHA, tensors)
    mpath.write_text(meta)
    return path


def logits_probe(torch, rt, ids: list, steps: int = 4):
    """The kernel path's logits over ``ids`` (one prefill chunk, every
    position) and ``steps`` decode steps of ids' first tokens after it: the
    prefill and decode kernels in one (n + steps, V) tensor."""
    kv = rt.new_cache(1, len(ids) + steps + 8)
    lg, kv, n = rt.eval_tokens(ids, kv, 0, all_logits=True)
    outs = [lg]
    for s, tok in enumerate(ids[:steps]):
        outs.append(llama_step(torch, rt, torch.tensor([[tok]], device=rt.device), kv,
                               n + s)[None])
    return torch.cat(outs)


def phase_lora(torch, gguf: Path, launches: dict, card: str) -> bool:
    """Phase 23: a LoRA adapter and the perplexity tool on the dense model
    of phase 4 at L32, loaded with q/k/v and gate/up unfused."""
    from ik_llama_cpp_tpu_torch.runtime import lora as LO
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    from ik_llama_cpp_tpu_torch.server import app
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    from ik_llama_cpp_tpu_torch.tools.perplexity import compute_perplexity
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rt = clone_layers(Runtime.from_gguf(gguf, fuse=False), L23)
    t0 = time.perf_counter()
    path = build_lora_gguf(ROOT / "build" / "smoke_lora.gguf", L23)
    adapter = LO.load_lora_gguf(path)
    log(f"[23] L{L23} unfused linears {sorted(set(_linear_kinds(rt)))} loaded in "
        f"{t0 - t_phase:.1f} s; adapter rank {adapter.rank} alpha {adapter.alpha} on "
        f"{len(adapter.tensors)} linears ({path.stat().st_size / 2**20:.1f} MiB f32 file, "
        f"ready and read in {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(23)
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    text = smoke_text(rng, 1500)
    n_text = len(rt.tokenizer.encode(text, parse_special=False))
    base = logits_probe(torch, rt, ids)
    ppl_base = compute_perplexity(rt, text, 512, verbose=False)
    t0 = time.perf_counter()
    LO.apply_lora(rt.params, adapter)
    sync(torch)
    log(f"[23] apply_lora: {time.perf_counter() - t0:.2f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    adapted = logits_probe(torch, rt, ids)
    moved = float((adapted - base).abs().max()) / float(base.abs().max())
    ok = moved > 1e-2
    log(f"[23] the adapter moves the logits (prefill and 4 decode steps) by {100 * moved:.2f}% "
        f"of the largest (gate > 1%): {'ok' if ok else 'FAIL'}")
    timed_run(torch, rt, ids[:64], 4)                       # warm
    kv = rt.new_cache(1, PREFILL + DECODE + 8)
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    logits, kv, n_past = rt.eval_tokens(ids, kv, 0)
    first = torch.argmax(logits[-1]).reshape(1, 1)
    sync(torch)
    t1 = time.perf_counter()
    counts_pre = read_counts()
    reset_counts()
    toks = rt._decode_loop(first, kv, n_past, DECODE)
    sync(torch)
    t2 = time.perf_counter()
    counts = read_counts()
    for k in counts:
        launches[k] = launches.get(k, 0) + counts_pre[k] + counts[k]
    per_a = 7 * L23 + 1
    got_pre = {k: n for k, n in counts_pre.items() if n}
    got_dec = {k: n for k, n in counts.items() if n}
    launch_ok = (got_pre == {"qmatmul_i8": per_a, "flash_attention": L23}
                 and got_dec == {"qmatmul_i8": per_a * DECODE,
                                 "flash_attention_decode": L23 * DECODE})
    ok &= launch_ok and bool(torch.isfinite(logits).all())
    log(f"[23] on {card}, with the adapter: prefill {PREFILL} tokens {(t1 - t0) * 1e3:.1f} ms = "
        f"{PREFILL / (t1 - t0):.1f} tok/s; decode {DECODE} tokens {(t2 - t1) * 1e3:.1f} ms = "
        f"{DECODE / (t2 - t1):.2f} tok/s; launches the chunk {got_pre}, a step "
        f"{ {k: n / DECODE for k, n in got_dec.items()} }; expected A {per_a} (7 x {L23} + 1) "
        f"and B / C {L23}: {launch_ok}")
    prof = profile_decode(torch, rt, kv, n_past + DECODE, toks[:, -1:], tag="23", top=10,
                          host=False)
    LO.strip_lora(rt.params)
    bare = profile_decode(torch, rt, kv, n_past + DECODE, toks[:, -1:], tag="23", top=4,
                          host=False)
    LO.apply_lora(rt.params, adapter)
    log(f"[23] decode step: kernel A {a_ms(prof)}; {c_ms(prof)}; all kernels "
        f"{sum(prof.values()):.3f} ms with the adapter, {sum(bare.values()):.3f} ms without "
        f"it (the same weights stripped): the low-rank products and their casts "
        f"{sum(prof.values()) - sum(bare.values()):.3f} ms a step")
    del kv, logits
    ok &= family_parity(torch, rt, PREFILL, f"the adapted dense 8B at L{L23}", 231, "23")
    ppl_k = compute_perplexity(rt, text, 512, verbose=False)
    with plain_path():
        ppl_p = compute_perplexity(rt, text, 512, verbose=False)
    good = n_text >= 1024 and abs(ppl_k[0] - ppl_p[0]) <= 2e-2 * ppl_p[0]
    log(f"[23] perplexity over smoke_text ({n_text} tokens, {ppl_k[2]} scored positions at "
        f"n_ctx 512): adapted kernel path {ppl_k[0]:.4f} +/- {ppl_k[1]:.4f}, adapted plain path "
        f"{ppl_p[0]:.4f} ({100 * (ppl_k[0] / ppl_p[0] - 1):+.3f}%, tol 2%), without the adapter "
        f"{ppl_base[0]:.4f}: {'ok' if good else 'FAIL'}")
    ok &= good
    LO.set_lora_scale(rt.params, 0.0, adapter)
    zero = logits_probe(torch, rt, ids)
    LO.strip_lora(rt.params)
    stripped = logits_probe(torch, rt, ids)
    good = bool(torch.equal(zero, base)) and bool(torch.equal(stripped, base))
    log(f"[23] scale 0: logits bit for bit the unadapted model's: {bool(torch.equal(zero, base))}"
        f"; after strip_lora: {bool(torch.equal(stripped, base))}: {'ok' if good else 'FAIL'}")
    ok &= good
    args = app.parse_args(["--gguf", str(gguf), "--lora", f"{path}:1", "--parallel", "1",
                           "--ctx-size", "1024"])
    loras = app.load_loras(rt, args.lora)
    eng = BatchEngine(rt, n_slots=args.parallel, capacity=args.ctx_size)
    srv = app.Server(eng, model_name=str(gguf))
    srv.loras = loras
    body = dict(prompt=smoke_text(rng, 60), n_predict=16, temperature=0.0, return_tokens=True)
    eng.start()
    try:
        listed = srv.lora_list()
        with_adapter = srv.completion(body)["tokens"]
        posted = srv.lora_set([{"id": 0, "scale": 0.0}])
        at_zero = srv.completion(body)["tokens"]
        LO.strip_lora(rt.params)
        eng.weights_epoch += 1
        base_tokens = srv.completion(body)["tokens"]
    finally:
        eng.stop()
    good = (listed == [{"id": 0, "path": str(path), "scale": 1.0}]
            and posted[0]["scale"] == 0.0 and at_zero == base_tokens and eng.n_failed == 0)
    log(f"[23] Server with --lora {path.name}:1 over a 1-slot engine: GET /lora-adapters "
        f"{listed}; a greedy completion with the adapter {with_adapter}; POST scale 0; the "
        f"same completion {at_zero}; the base model's {base_tokens}: equal token for token: "
        f"{at_zero == base_tokens}: {'ok' if good else 'FAIL'}")
    ok &= good
    log(f"[23] LoRA and perplexity at L{L23}: {time.perf_counter() - t_phase:.1f} s")
    del eng, srv
    ok &= hidden_paths(torch, rt, launches, card)
    del rt
    torch.cuda.empty_cache()
    return ok


def counted(torch, launches: dict, fn):
    """fn() with the launch counters zeroed just before and read just after
    (added into ``launches``): (its result, its wall seconds, the counts
    that are not zero)."""
    reset_counts()
    res, secs = wall_of(torch, fn)
    counts = read_counts()
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    return res, secs, {k: n for k, n in counts.items() if n}


def probe_rows(n_past: int, toks, prompt_len: int, gen: list, lay) -> list:
    """The rows of a lookahead probe whose history is the greedy one, each
    as (probe row, index into the greedy steps' logits): row 0 (``cur`` at
    n_past) and each verification gram's rows while the gram follows the
    greedy tokens. Step s's logits predict gen[s] (greedy's last step,
    len(gen), the token after them)."""
    k = n_past - prompt_len              # cur is gen[k]
    out = [(0, k + 1)]
    n = lay.N
    for gi in range(lay.G):
        base = 1 + gi * (n - 1)
        for j in range(n - 1):
            if k + 1 + j >= len(gen) or int(toks[base + j]) != gen[k + 1 + j]:
                break
            out.append((base + j, k + 2 + j))
    return [(r, s) for r, s in out if s <= len(gen)]


def lookahead_gate(torch, rt, launches: dict, card: str, prompt: list) -> bool:
    """Lookahead decoding (W, N, G = LOOKAHEAD_WNG) over LOOKAHEAD_NEW
    tokens: a free run (tokens, rounds, accepted tokens a round, tok/s,
    launches), then the one-history gate: a run fed greedy decode's tokens,
    each probe row whose history is the greedy one held to the greedy decode
    step at the same position (within 5% of that step's largest |logit|:
    the probe's plain attention and kernel C round differently)."""
    from ik_llama_cpp_tpu_torch.runtime import lookahead as LA
    w, n, g = LOOKAHEAD_WNG
    gen, steps = greedy(torch, rt, prompt, LOOKAHEAD_NEW)
    (_, out, st), secs, counts = counted(torch, launches, lambda: LA.generate_lookahead(
        rt, prompt, LOOKAHEAD_NEW, W=w, N=n, G=g, capacity=len(prompt) + 256,
        stop_at_eos=False))
    same = next((i for i, (a, b) in enumerate(zip(out, gen)) if a != b), len(out))
    log(f"[23] lookahead W {w} N {n} G {g} (probe of {LA._Layout(w, n, g).T} rows) on {card}: "
        f"{len(out)} tokens in {secs:.2f} s = {len(out) / secs:.2f} tok/s, {st.n_rounds} "
        f"rounds, {st.n_accept} gram tokens accepted = {st.n_accept / st.n_rounds:.3f} a "
        f"round ({(len(out) - 1) / st.n_rounds:.3f} tokens a round); the first {same} tokens "
        f"greedy decode's; launches {counts}")
    lay = LA._Layout(w, n, g)
    seen, orig_probe, orig_sample = [], rt.eval_probe, LA.sample_token

    def probe(toks, positions, mask, kv, n_past):
        lg = orig_probe(toks, positions, mask, kv, n_past)
        seen.append((n_past, np.asarray(toks).copy(), lg))
        return lg

    rt.eval_probe = probe
    LA.sample_token = lambda lg, sampler, rng, history: gen[len(history) - len(prompt)]
    try:
        (_, forced, fst), _, _ = counted(torch, launches, lambda: LA.generate_lookahead(
            rt, prompt, LOOKAHEAD_NEW, W=w, N=n, G=g, capacity=len(prompt) + 256,
            stop_at_eos=False))
    finally:
        del rt.eval_probe                # the instance's wrapper; the method again
        LA.sample_token = orig_sample
    worst, rows = 0.0, 0
    for n_past, toks, lg in seen:
        for r, si in probe_rows(n_past, toks, len(prompt), gen, lay):
            ref = steps[si]
            worst = max(worst, float((lg[r] - ref).abs().max() / ref.abs().max()))
            rows += 1
    ok = forced == gen and rows > 0 and worst <= 5e-2
    log(f"[23] lookahead fed greedy decode's tokens: {fst.n_rounds} rounds, {fst.n_accept} "
        f"gram tokens accepted = {fst.n_accept / fst.n_rounds:.3f} a round; {rows} probe rows "
        f"on the greedy history, the largest gap to the decode step at the same position "
        f"{100 * worst:.3f}% of its largest |logit| (tol 5%): {'ok' if ok else 'FAIL'}")
    return ok


def embed_gaps(got, ref) -> tuple:
    """The kernel path's final states ``got`` (T, E) against the plain
    path's ``ref``: (the largest L2 distance of the mean-pooled and of the
    first position's unit vectors, what Runtime.embed returns pooled; the
    largest L2 distance of one position's unit vectors, what pooling 'none'
    gives after the L2 normalization, which no pooling dilutes; text with
    both and the states' largest element-wise gap over the largest
    |state|)."""
    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    dist = max(float(np.linalg.norm(unit(got.mean(0)) - unit(ref.mean(0)))),
               float(np.linalg.norm(unit(got[0]) - unit(ref[0]))))
    row = float(np.linalg.norm(unit(got) - unit(ref), axis=-1).max())
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    return dist, row, (f"the mean-pooled and first-position unit vectors at most {dist:.5f} "
                       f"apart (L2), one position's at most {row:.5f}; the states' largest "
                       f"gap {100 * rel:.3f}% of the largest |state|")


def bert_layer_gaps(torch, rt, ids: list) -> tuple:
    """The one-history form for an encoder: every layer of the plain path
    fed the kernel path's input to that layer (``layer_hiddens``), its
    output against the kernel path's, as the largest gap over the largest
    |state| a layer; and the free-running plain path's layer outputs
    against the kernel path's. Returns (teacher-forced gaps, free gaps,
    the kernel path's and the free plain path's final states (T, E) on
    the host)."""
    from ik_llama_cpp_tpu_torch.models import bert as TB
    hs = rt.layer_hiddens(ids)
    tokens = torch.tensor([ids], device=rt.device)
    ctx = TB.layer_context(rt.cfg, 1, len(ids), None, rt.device)
    forced, prev = [], TB.embed_input(rt.params, rt.cfg, tokens, ctx)
    with plain_path():
        for blk, ref in zip(rt.params["blocks"], hs):
            out = TB.layer(blk, prev, rt.cfg, ctx)[0]
            forced.append(float((out - ref).abs().max() / ref.abs().max()))
            prev = ref[None]
        free = rt.layer_hiddens(ids)
    gaps = ((free - hs).abs().amax(dim=(1, 2)) / hs.abs().amax(dim=(1, 2))).tolist()
    return forced, gaps, hs[-1].cpu().numpy(), free[-1].cpu().numpy()


def flipped_plain(torch, rt, ids: list, seed: int):
    """The second witness of how the encoder's depth grows a small gap: the
    plain path run free over ids with one bf16 rounding flipped in every
    layer (one element of the layer's input, picked at random, moved to
    the bf16 value on the other side of it, so that the layer's bf16
    operand there is one step off). Its final states (T, E) on the host."""
    from ik_llama_cpp_tpu_torch.models import bert as TB
    gen = np.random.default_rng(seed)
    tokens = torch.tensor([ids], device=rt.device)
    ctx = TB.layer_context(rt.cfg, 1, len(ids), None, rt.device)
    with plain_path():
        x = TB.embed_input(rt.params, rt.cfg, tokens, ctx)
        for blk in rt.params["blocks"]:
            flat = x.view(-1)
            j = int(gen.integers(flat.numel()))
            r = flat[j].to(torch.bfloat16)
            step = 1 if r.float().abs() <= flat[j].abs() else -1   # sign-magnitude bits
            flat[j] = (r.view(torch.int16) + step).view(torch.bfloat16).float()
            x = TB.layer(blk, x, rt.cfg, ctx)
    return x[0].cpu().numpy()


def hidden_paths(torch, rt, launches: dict, card: str) -> bool:
    """Phase 23's hidden-state paths on its loaded dense model (L32,
    q/k/v and gate/up unfused, the adapter stripped): layer_hiddens over 512
    tokens, generate_control_vector over 4 prompt pairs, the embedding of a
    300-token input padded to its bucket of 512 (n_valid) against the plain
    path, and lookahead decoding."""
    from ik_llama_cpp_tpu_torch.runtime.cvector import generate_control_vector
    rng = np.random.default_rng(230)
    per_a = 7 * L23                       # the unfused linears, no head
    ids = [int(x) for x in rng.integers(3, V, PREFILL)]
    rt.layer_hiddens(ids[:64])           # warm
    hs, secs, counts = counted(torch, launches, lambda: rt.layer_hiddens(ids))
    ok = (counts == {"qmatmul_i8": per_a, "flash_attention": L23}
          and hs.shape == (L23, PREFILL, E) and bool(torch.isfinite(hs).all()))
    log(f"[23] layer_hiddens over {PREFILL} tokens on {card}: {tuple(hs.shape)} f32 in "
        f"{secs * 1e3:.1f} ms; launches {counts}, expected A {per_a} (7 x {L23}, no head) and "
        f"B {L23}: {'ok' if ok else 'FAIL'}")
    del hs
    pos = [smoke_text(rng, 12 + 3 * i) for i in range(4)]
    neg = [smoke_text(rng, 12 + 3 * i) for i in range(4)]
    cv, secs, counts = counted(torch, launches, lambda: generate_control_vector(rt, pos, neg))
    good = cv.shape == (L23, E) and bool(np.allclose(np.linalg.norm(cv, axis=1), 1.0, atol=1e-4))
    log(f"[23] generate_control_vector (pca) over 4 prompt pairs: {cv.shape} unit directions "
        f"in {secs:.2f} s, launches {counts}: {'ok' if good else 'FAIL'}")
    ok &= good
    doc = ids[:300]
    e, secs, counts = counted(torch, launches, lambda: rt.embed(doc, "none"))
    with plain_path():
        ep = rt.embed(doc, "none")
    dist, row, text = embed_gaps(e, ep)
    good = (dist <= 2e-2 and row <= EMBED23_ROW_TOL
            and counts == {"qmatmul_i8": per_a, "flash_attention": L23} and e.shape == (300, E))
    log(f"[23] embed of {len(doc)} tokens padded to the bucket of {PREFILL} (n_valid "
        f"{len(doc)}): {secs * 1e3:.1f} ms, launches {counts}; against the plain path: "
        f"{text} (tol 2e-2 pooled, a cosine of 0.9998, and {EMBED23_ROW_TOL} a position): "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    ok &= lookahead_gate(torch, rt, launches, card, ids[:128])
    return ok


def build_bert_gguf(path: Path, c: dict = BGEM3) -> Path:
    """BGE-M3 as GGUF arch bert at its full depth, every layer its own:
    Q4_0 q/k/v/o, ffn_up and ffn_down with float32 biases, a Q8_0 token
    embedding, float32 positions, token type and LayerNorms (near 1 and
    near 0), random from seed 0, and spm_vocab's SentencePiece vocabulary
    of V pieces filled up to the model's size with pieces '<x000000>' ...
    (spm_vocab's random pieces of two and three letters run out near
    36,000). Cached beside a .meta."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    meta = json.dumps(dict(v=BERT_GGUF_VERSION, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, e, ff, v = c["ARCH"], c["E"], c["FF"], c["V"]
    w = GGUFWriter(str(path), arch=arch)
    for key, val in (("block_count", c["L"]), ("context_length", c["CTX"]),
                     ("embedding_length", e), ("feed_forward_length", ff),
                     ("attention.head_count", c["H"]), ("attention.head_count_kv", c["H"]),
                     ("attention.layer_norm_epsilon", c["EPS"]), ("attention.causal", False),
                     ("pooling_type", 2), ("vocab_size", v)):
        w.add(f"{arch}.{key}", val)
    tokens, scores, types = spm_vocab(min(v, V))
    fill = v - len(tokens)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens + [f"<x{i:06d}>" for i in range(fill)])
    w.add("tokenizer.ggml.scores", np.asarray(scores + [scores[-1] - 1.0 - i
                                                        for i in range(fill)], np.float32))
    w.add("tokenizer.ggml.token_type", np.asarray(types + [1] * fill, np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0):
        w.add_tensor(name, _rand_blocks(rng, rows, cols, ttype), shape=(cols, rows),
                     ggml_type=ttype)

    def f32(name, *shape, mean=0.0, std=0.02):
        w.add_tensor(name, (mean + std * rng.standard_normal(shape)).astype(np.float32))

    q("token_embd.weight", v, e, GGMLType.Q8_0)
    f32("token_types.weight", c["TYPES"], e)
    f32("position_embd.weight", c["CTX"], e)
    f32("token_embd_norm.weight", e, mean=1.0)
    f32("token_embd_norm.bias", e)
    for i in range(c["L"]):
        p = f"blk.{i}."
        for name, rows, cols in (("attn_q", e, e), ("attn_k", e, e), ("attn_v", e, e),
                                 ("attn_output", e, e), ("ffn_up", ff, e), ("ffn_down", e, ff)):
            q(p + name + ".weight", rows, cols)
            f32(p + name + ".bias", rows)
        for name in ("attn_output_norm", "layer_output_norm"):
            f32(p + name + ".weight", e, mean=1.0)
            f32(p + name + ".bias", e)
    w.write()
    mpath.write_text(meta)
    return path


def phase_bert(torch, launches: dict, card: str) -> bool:
    """Phase 24: the BERT encoder family at the full width and depth of
    BGE-M3 (L24): Runtime.embed over token-id documents of EMBED_LENGTHS
    tokens with tok/s and the exact count of kernel-A launches a forward,
    profiles of the 512- and 8,192-token forwards (kernel A, the plain
    attention's kernels, the wall and the idle share), peak memory, the
    kernel path against the plain path over one history (each layer of the
    plain path fed the kernel path's input) and run free (beside the plain
    path against itself with one bf16 rounding flipped a layer), and the
    server's /v1/embeddings, /embedding and /rerank, whose vectors and
    scores must equal Runtime.embed's bit for bit."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    from ik_llama_cpp_tpu_torch.server import app
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    c = BGEM3
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gguf = build_bert_gguf(ROOT / "build" / "smoke_bgem3.gguf", c)
    t1 = time.perf_counter()
    rt = Runtime.from_gguf(gguf)
    sync(torch)
    t2 = time.perf_counter()
    kinds = sorted(set(_linear_kinds(rt)))
    log(f"[24] BGE-M3 (bert L{c['L']} E{c['E']} H{c['H']} FF{c['FF']} V{c['V']}, {c['CTX']} "
        f"positions): file ({gguf.stat().st_size / 2**20:.0f} MiB) ready in {t1 - t_phase:.1f} s, "
        f"loaded in {t2 - t1:.1f} s; linears {kinds}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(24)
    per_a = 6 * c["L"]                   # q, k, v, o, up and down a layer; no head
    ok = kinds == ["QLinearI8"]
    docs = {n: [int(x) for x in rng.integers(3, c["V"], n)] for n in EMBED_LENGTHS}
    vecs = {}
    for n, ids in docs.items():
        rt.embed(ids, "cls")             # warm at this shape
        vec, secs, counts = counted(torch, launches, lambda: rt.embed(ids, "cls"))
        vecs[n] = vec
        good = (counts == {"qmatmul_i8": per_a} and vec.shape == (c["E"],)
                and bool(np.isfinite(vec).all()))
        log(f"[24] on {card}: embed (cls) of {n} tokens: {secs * 1e3:.1f} ms = "
            f"{n / secs:.0f} tok/s; launches {counts}, "
            f"expected A {per_a} (6 x {c['L']}) and nothing else: {'ok' if good else 'FAIL'}")
        ok &= good
    log(f"[24] peak memory over the five documents {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB on {card}")
    for n in (512, 8192):
        ids = docs[n]
        prof = profile_window(torch, lambda: rt.embed(ids, "cls"), 1, f"the {n}-token forward",
                              "forward", "24", top=8, host=False)
        a = kernel_ms(prof, "qmatmul_i8")
        log(f"[24] {n}-token forward on {card}: kernel A {a_ms(prof)}; the plain attention, "
            f"norms and casts {sum(prof.values()) - a:.3f} ms; all kernels "
            f"{sum(prof.values()):.3f} ms")
    forced, free, got, ref = bert_layer_gaps(torch, rt, docs[512])
    good = max(forced) <= 1e-2
    log(f"[24] kernel path against the plain path over one history, 512 tokens: each "
        f"layer of the plain path fed the kernel path's input, its output at most "
        f"{100 * max(forced):.4f}% of the largest |state| apart (layer by layer "
        f"{', '.join(f'{100 * g:.4f}' for g in forced[:4])}, ... {100 * forced[-1]:.4f}%; "
        f"tol 1%: kernel A against its plain version, then a bf16 rounding flip or an "
        f"int8 activation step inside the layer): {'ok' if good else 'FAIL'}")
    ok &= good
    dist, row, text = embed_gaps(got, ref)
    w_dist, _, w_text = embed_gaps(flipped_plain(torch, rt, docs[512], 241), ref)
    good = dist <= BGE_FREE_TOL and row <= BGE_ROW_TOL and dist <= BGE_WITNESS_X * w_dist
    log(f"[24] run free over 512 tokens, the kernel path against the plain path: {text} "
        f"(tol {BGE_FREE_TOL} pooled and {BGE_ROW_TOL} a position, and pooled at most "
        f"{BGE_WITNESS_X} x the second witness's): {'ok' if good else 'FAIL'}; the gap through the {len(free)} post-LN layers of random weights (layer: % of its "
        f"largest |state|): "
        f"{', '.join(f'{i + 1}: {100 * free[i]:.3f}' for i in range(0, len(free), 4))}, "
        f"{len(free)}: {100 * free[-1]:.3f}. Second witness, the plain path against itself "
        f"with one bf16 rounding flipped a layer: {w_text}")
    ok &= good
    eng = BatchEngine(rt, n_slots=1, capacity=c["CTX"])
    srv = app.Server(eng, model_name=str(gguf))
    eng.start()
    try:
        a, b = docs[100], docs[512]
        oai = srv.oai_embeddings({"input": [a, b]})
        native = srv.embeddings({"content": [a], "pooling": "cls"})
        query = smoke_text(rng, 12)
        texts = [smoke_text(rng, 20 + 10 * i) for i in range(3)]
        rr = srv.rerank({"query": query, "documents": texts})
        refused = False
        try:
            srv.completion({"prompt": query, "n_predict": 2})
        except app.RequestError as err:
            refused = err.status == 400
    finally:
        eng.stop()
    tok = rt.tokenizer
    qe = rt.embed(tok.encode(query), "mean")
    scores = {i: float(np.dot(qe, rt.embed(tok.encode(t), "mean"))) for i, t in enumerate(texts)}
    good = (oai["data"][0]["embedding"] == rt.embed(a, "mean").tolist()
            and oai["data"][1]["embedding"] == rt.embed(b, "mean").tolist()
            and native[0]["embedding"] == rt.embed(a, "cls").tolist()
            and all(r["relevance_score"] == scores[r["index"]] for r in rr["results"])
            and [r["index"] for r in rr["results"]] == sorted(scores, key=lambda i: -scores[i])
            and refused and eng.n_failed == 0)
    log(f"[24] Server over a 1-slot engine on the encoder: /v1/embeddings of 100 and 512 ids, "
        f"/embedding of 100 ids (cls), /rerank of 3 texts (scores "
        f"{[round(r['relevance_score'], 4) for r in rr['results']]}), each equal to "
        f"Runtime.embed's bit for bit; a completion refused with a 400 {refused}: "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    log(f"[24] BGE-M3 at L{c['L']}: {time.perf_counter() - t_phase:.1f} s")
    del rt, eng, srv
    torch.cuda.empty_cache()
    return ok


KERNELS = {
    "qmatmul_i8": ("ik_llama_cpp_tpu_torch/csrc/qmatmul_i8.cu",
                   "ik_llama_cpp_tpu/ops/qmatmul.py:474", "M=1 K=4096 N=28672"),
    "flash_attention": ("ik_llama_cpp_tpu_torch/csrc/flash_attention.cu",
                        "ik_llama_cpp_tpu/ops/flash_attention.py:136",
                        "B=1 T=512 S=1024 q_pos0=[0] kv_len=[512]"),
    "flash_attention_decode": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_decode.cu",
                               "ik_llama_cpp_tpu/ops/flash_attention.py:770",
                               "B=1 T=1 S=1024 q_pos0=[512] kv_len=[513]"),
    "qmatmul": ("ik_llama_cpp_tpu_torch/csrc/qmatmul.cu",
                "ik_llama_cpp_tpu/ops/qmatmul.py:96", "M=1 K=4096 N=28672"),
    "qmatmul_wgmma": ("ik_llama_cpp_tpu_torch/csrc/qmatmul.cu",
                      "ik_llama_cpp_tpu/ops/qmatmul.py:96", "M=512 K=4096 N=28672"),
    "moe_decode_gate_up_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_i8.cu",
                              "ik_llama_cpp_tpu/ops/moe_decode.py:392",
                              "P=8 K=2048 FF=768 G=128"),
    "moe_decode_down_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_i8.cu",
                           "ik_llama_cpp_tpu/ops/moe_decode.py:521",
                           "P=8 FF=768 E=2048 G=128"),
    "fused_moe_prefill_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm_i8.cu",
                             "ik_llama_cpp_tpu/ops/moe_qmm.py:439",
                             "G=128 R=40 K=2048 FF=768 E=2048 n_live=128"),
    "ragged_qmatmul_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm_i8.cu",
                          "ik_llama_cpp_tpu/ops/moe_qmm.py:157",
                          "M=4096 K=2048 N=768 skewed"),
    "flash_attention_decode_q8": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_decode_q.cu",
                                  "ik_llama_cpp_tpu/ops/flash_attention.py:795",
                                  "q8 B=1 T=1 S=1024 q_pos0=[512] kv_len=[513]"),
    "flash_attention_q8": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_q8.cu",
                           "ik_llama_cpp_tpu/ops/flash_attention.py:313",
                           "q8 B=1 T=512 S=1024 q_pos0=[0] kv_len=[512]"),
    "qmatmul4": ("ik_llama_cpp_tpu_torch/csrc/qmatmul4.cu",
                 "ik_llama_cpp_tpu/ops/qmatmul.py:243", "M=1 K=4096 N=28672"),
    "qmatmul4_wgmma": ("ik_llama_cpp_tpu_torch/csrc/qmatmul4.cu",
                       "ik_llama_cpp_tpu/ops/qmatmul.py:243", "M=512 K=4096 N=28672"),
    "moe_decode_fused_i8": ("ik_llama_cpp_tpu_torch/csrc/moe_decode_fused_i8.cu",
                            "ik_llama_cpp_tpu/ops/moe_decode.py:686",
                            "P=8 K=2048 FF=768 E=2048 G=128"),
    "moe_decode_gate_up": ("ik_llama_cpp_tpu_torch/csrc/moe_decode.cu",
                           "ik_llama_cpp_tpu/ops/moe_decode.py:112",
                           "P=4 K=2048 FF=1408 G=60 group=256 f32 scales"),
    "moe_decode_down": ("ik_llama_cpp_tpu_torch/csrc/moe_decode.cu",
                        "ik_llama_cpp_tpu/ops/moe_decode.py:246",
                        "P=4 FF=1408 E=2048 G=60 group=32 bf16 scales"),
    "ragged_qmatmul": ("ik_llama_cpp_tpu_torch/csrc/moe_qmm.cu",
                       "ik_llama_cpp_tpu/ops/moe_qmm.py:286",
                       "M=2048 K=1408 N=2048 G=60 group=32 random"),
    "qmatmul_pair": ("ik_llama_cpp_tpu_torch/csrc/qmatmul.cu",
                     "ik_llama_cpp_tpu/tools/perf_dequant.py:69", "M=16 K=4096 N=14336"),
    "flash_attention_mla": ("ik_llama_cpp_tpu_torch/csrc/flash_attention_mla.cu",
                            "ik_llama_cpp_tpu/ops/flash_attention.py:136",
                            "B=1 T=512 S=4096 q_pos0=[3488] kv_len=[4000] H=16 HKV=1 Dk=576 "
                            "Dv=512"),
}


def summary(results, launches) -> list:
    out = []
    for name, (src, repl, shape) in KERNELS.items():
        rows = results.get(name, [])
        pick = next((r for r in rows if r["case"] == shape), rows[0] if rows else None)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches.get(name, 0),
            "max_abs_err": max((r["err"] for r in rows), default=None),
            "shape": pick["case"] if pick else None,
            "ms": pick["ms"] if pick else None,
            "plain_ms": pick["plain_ms"] if pick else None,
            "bound_ms": pick["bound_ms"] if pick else None,
            "bound_by": pick["bound_by"] if pick else None,
            "library_ms": pick["library_ms"] if pick else None})
    return out


# ------------------------------------------------------------- phase 25 --
def _rand_f16(rng, *shape) -> np.ndarray:
    """Random f16 weights of about 1/sqrt(fan-in) (the last axis)."""
    fan = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return (rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(fan))).astype(
        np.float16)


def _rand_norm(rng, n: int):
    """A LayerNorm's f32 (weight, bias): about one and about zero."""
    return ((1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32),
            (0.02 * rng.standard_normal(n)).astype(np.float32))


def _encoder_blocks(w, rng, pre: str, c: dict, k_bias: bool) -> None:
    """c["L"] pre-LN blocks of width c["E"] / c["FF"]: f16 linears, f32
    biases and norms (whisper's k projection has no bias)."""
    e, ff = c["E"], c["FF"]
    for i in range(c["L"]):
        p = f"{pre}.blk.{i}."
        for tn, rows, cols, bias in (("attn_q", e, e, True), ("attn_k", e, e, k_bias),
                                     ("attn_v", e, e, True), ("attn_out", e, e, True),
                                     ("ffn_up", ff, e, True), ("ffn_down", e, ff, True)):
            w.add_tensor(p + tn + ".weight", _rand_f16(rng, rows, cols))
            if bias:
                w.add_tensor(p + tn + ".bias", (0.02 * rng.standard_normal(rows)).astype(np.float32))
        for ln in ("ln1", "ln2"):
            wt, b = _rand_norm(rng, e)
            w.add_tensor(p + ln + ".weight", wt)
            w.add_tensor(p + ln + ".bias", b)


def build_mmproj_gguf(path: Path, kind: str) -> Path:
    """An f16 mmproj at full width, random from seed 25 (cached beside a
    .meta): ``vision``, CLIP ViT-L/14-336 with the llava mlp projector
    (CLIP_L336), or ``audio``, whisper-large-v3's encoder with the qwen2a
    projector (WHISPER_L3); f32 biases, norms and position embeddings."""
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    c = CLIP_L336 if kind == "vision" else WHISPER_L3
    meta = json.dumps(dict(v=MM_GGUF_VERSION, kind=kind, **c))
    mpath = path.with_suffix(".meta")
    if path.exists() and mpath.exists() and mpath.read_text() == meta:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(25)
    w = GGUFWriter(str(path), arch="clip")
    e = c["E"]
    if kind == "vision":
        w.add("clip.has_vision_encoder", True)
        w.add("clip.projector_type", "mlp")
        for key, val in (("image_size", c["IMAGE"]), ("patch_size", c["PATCH"]),
                         ("embedding_length", e), ("feed_forward_length", c["FF"]),
                         ("block_count", c["L"]), ("attention.head_count", c["H"]),
                         ("attention.layer_norm_epsilon", 1e-5),
                         ("projection_dim", c["PROJ"])):
            w.add(f"clip.vision.{key}", val)
        w.add("clip.vision.image_mean", np.asarray([0.48145466, 0.4578275, 0.40821073],
                                                   np.float32))
        w.add("clip.vision.image_std", np.asarray([0.26862954, 0.26130258, 0.27577711],
                                                  np.float32))
        ps = c["PATCH"]
        n_pos = (c["IMAGE"] // ps) ** 2 + 1
        w.add_tensor("v.patch_embd.weight", _rand_f16(rng, e, 3, ps, ps))
        w.add_tensor("v.class_embd", (0.02 * rng.standard_normal(e)).astype(np.float32))
        w.add_tensor("v.position_embd.weight",
                     (0.02 * rng.standard_normal((n_pos, e))).astype(np.float32))
        wt, b = _rand_norm(rng, e)
        w.add_tensor("v.pre_ln.weight", wt)
        w.add_tensor("v.pre_ln.bias", b)
        _encoder_blocks(w, rng, "v", c, True)
        w.add_tensor("mm.0.weight", _rand_f16(rng, c["PROJ"], e))
        w.add_tensor("mm.0.bias", (0.02 * rng.standard_normal(c["PROJ"])).astype(np.float32))
        w.add_tensor("mm.2.weight", _rand_f16(rng, c["PROJ"], c["PROJ"]))
        w.add_tensor("mm.2.bias", (0.02 * rng.standard_normal(c["PROJ"])).astype(np.float32))
    else:
        w.add("clip.has_audio_encoder", True)
        w.add("clip.projector_type", "qwen2a")
        for key, val in (("num_mel_bins", c["MEL"]), ("embedding_length", e),
                         ("feed_forward_length", c["FF"]), ("block_count", c["L"]),
                         ("attention.head_count", c["H"]),
                         ("attention.layer_norm_epsilon", 1e-5), ("projection_dim", c["PROJ"])):
            w.add(f"clip.audio.{key}", val)
        w.add_tensor("a.conv1d.1.weight", _rand_f16(rng, e, c["MEL"], 3))
        w.add_tensor("a.conv1d.1.bias", (0.02 * rng.standard_normal((e, 1))).astype(np.float32))
        w.add_tensor("a.conv1d.2.weight", _rand_f16(rng, e, e, 3))
        w.add_tensor("a.conv1d.2.bias", (0.02 * rng.standard_normal((e, 1))).astype(np.float32))
        w.add_tensor("a.position_embd.weight",
                     (0.02 * rng.standard_normal((c["POS"], e))).astype(np.float32))
        wt, b = _rand_norm(rng, e)
        w.add_tensor("a.post_ln.weight", wt)
        w.add_tensor("a.post_ln.bias", b)
        _encoder_blocks(w, rng, "a", c, False)
        w.add_tensor("mm.a.fc.weight", _rand_f16(rng, c["PROJ"], e))
        w.add_tensor("mm.a.fc.bias", (0.02 * rng.standard_normal(c["PROJ"])).astype(np.float32))
    w.write()
    mpath.write_text(meta)
    return path


def smoke_png(width: int = 640, height: int = 480) -> bytes:
    """A width x height RGB PNG made from seed 25: gradients, a disc and
    noise, its rows in all five filters."""
    from ik_llama_cpp_tpu_torch.runtime.media import encode_png
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    disc = ((x - width * 0.6) ** 2 + (y - height * 0.4) ** 2) < (height * 0.25) ** 2
    img = np.stack([x / width * 255, y / height * 255, 128 + 100 * disc], axis=-1)
    img += np.random.default_rng(25).normal(0, 12, img.shape)
    return encode_png(np.clip(img, 0, 255).astype(np.uint8))


def smoke_wav(seconds: float) -> bytes:
    """``seconds`` of 16 kHz mono PCM16 WAV from seed 25: two chirps and noise."""
    import io
    import wave
    t = np.arange(int(seconds * 16000)) / 16000.0
    s = (0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.2 * np.sin(2 * np.pi * 3000 * t * t / seconds)
         + 0.05 * np.random.default_rng(25).standard_normal(len(t)))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(s, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def mm_case(torch, rt, srv, enc, enc_cpu, part: dict, media, kind: str, card: str) -> bool:
    """One media chat on phase 25's server (its engine thread running): the
    encoder on the card against the CPU, the chat through Server.oai_chat,
    the same splice and decode driven here with the launches of each
    prefill chunk and decode step counted, and the one-history parity."""
    from ik_llama_cpp_tpu_torch.runtime import mtmd
    from ik_llama_cpp_tpu_torch.runtime.mtmd_audio import preprocess_audio
    from ik_llama_cpp_tpu_torch.models.clip import preprocess_image
    tag = f"25{'a' if kind == 'vision' else 'b'}"
    text_part = {"type": "text", "text": "Describe this in a few words."}
    body = {"messages": [{"role": "user", "content": [text_part, part]}],
            "max_tokens": MM_NEW, "temperature": 0.0}
    # the encoder: the card against the same function on the CPU in float32
    t0 = time.perf_counter()
    x = (preprocess_image(media, enc.cfg) if kind == "vision"
         else preprocess_audio(np.asarray(media, np.float32))[0])
    host_ms = (time.perf_counter() - t0) * 1e3
    xt = torch.from_numpy(np.ascontiguousarray(x))
    enc_ms = event_ms(torch, lambda: enc(xt.to(rt.device)), 3)
    got = enc(xt.to(rt.device)).float().cpu()
    want = enc_cpu(xt)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    enc_ok = bool(torch.isfinite(got).all()) and err <= MM_ENC_TOL * scale
    log(f"[{tag}] encoder {'CLIP ViT-L/14-336' if kind == 'vision' else 'whisper-large-v3'}: "
        f"{tuple(got.shape)} rows out, {enc_ms:.2f} ms on the card (CUDA events), host "
        f"preprocessing {host_ms:.1f} ms; against the CPU in float32 max_abs_err {err:.3e} of "
        f"max |out| {scale:.3f} (tol {MM_ENC_TOL:g} of it): {'ok' if enc_ok else 'FAIL'}")
    # the chat through the server, mtmd on the engine's loop thread
    reset_counts()
    t0 = time.perf_counter()
    res = srv.oai_chat(body)
    sync(torch)
    chat_s = time.perf_counter() - t0
    chat_counts = {k: n for k, n in read_counts().items() if n}
    reply = res["choices"][0]["message"]["content"]
    usage = res["usage"]
    # the same splice and decode here, timed and counted by part
    messages = srv._extract_images(body["messages"])[0]
    prompt = srv._chat_prompt(messages)
    embds = mtmd.build_mm_embeds(rt, prompt, [media], srv.clip, audio_encoder=srv.audio)
    n_rows = embds.shape[0]
    kv = rt.new_cache(1, n_rows + MM_NEW + 8)
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    logits, kv, n_past = mtmd.eval_embeds(rt, embds, kv, 0)
    sync(torch)
    pre_s = time.perf_counter() - t0
    pre_counts = {k: n for k, n in read_counts().items() if n}
    chunks = -(-n_rows // 512)
    gen = [int(torch.argmax(logits))]
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(MM_NEW - 1):
        lg, kv, n_past = rt.eval_tokens([gen[-1]], kv, n_past)
        gen.append(int(torch.argmax(lg[-1])))
    sync(torch)
    dec_s = time.perf_counter() - t0
    dec_counts = {k: n for k, n in read_counts().items() if n}
    per = 4 * NL + 1
    want_pre = {"qmatmul_i8": per * chunks, "flash_attention": NL * chunks}
    want_dec = {"qmatmul_i8": per * (MM_NEW - 1), "flash_attention_decode": NL * (MM_NEW - 1)}
    eos = rt.tokenizer.eos_id
    upto = gen[:gen.index(eos) + 1] if eos in gen else gen
    same_text = srv._mm_message(rt.tokenizer.decode([t for t in upto if t != eos]))[
        "content"] == reply
    counts_ok = pre_counts == want_pre and dec_counts == want_dec and \
        chat_counts.get("qmatmul_i8", 0) > 0 and chat_counts.get("flash_attention", 0) > 0
    log(f"[{tag}] chat through Server.oai_chat in {chat_s:.2f} s: {usage['prompt_tokens']} "
        f"prompt rows ({got.shape[0]} spliced), {usage['completion_tokens']} tokens, launches "
        f"{chat_counts}; the reply is the greedy decode driven here: {same_text}")
    log(f"[{tag}] prefill by rows: {n_rows} rows in {chunks} chunks, {pre_s * 1e3:.1f} ms = "
        f"{n_rows / pre_s:.1f} rows/s, launches {pre_counts} (expected {want_pre}: A "
        f"{per} and B {NL} a chunk); decode {MM_NEW - 1} steps {dec_s * 1e3:.1f} ms = "
        f"{(MM_NEW - 1) / dec_s:.2f} tok/s, launches {dec_counts} (expected {want_dec}: A "
        f"{per} and C {NL} a step); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{card}: {'ok' if counts_ok else 'FAIL'}")
    # one history: the plain path fed the kernel path's greedy tokens
    def history():
        lg0, kv_, n_ = mtmd.eval_embeds(rt, embds, rt.new_cache(1, n_rows + MM_NEW + 8), 0)
        rest = rt.eval_tokens(gen[:-1], kv_, n_, all_logits=True)[0]
        return torch.cat([lg0[None], rest], dim=0)
    lk = history()
    with plain_path():
        lp = history()
    good, text = parity_verdict(lk, lp)
    log(f"[{tag}] parity over one history (the splice, then {MM_NEW} greedy tokens): {text}: "
        f"{'ok' if good else 'FAIL'}")
    del kv, lk, lp
    return enc_ok and counts_ok and same_text and good and bool(usage["completion_tokens"])


def phase_multimodal(torch, rt, card: str) -> bool:
    """Phase 25: the multimodal path on phase 16's loaded L32 model (the
    dense bench widths, Mistral-7B's and so LLaVA-1.6-Mistral-7B's text
    tower): (a) an f16 CLIP ViT-L/14-336 mmproj with the llava projector
    and a 640 x 480 PNG, (b) an f16 whisper-large-v3 / qwen2a mmproj and
    MM_AUDIO_S seconds of PCM16 WAV, each as a chat through
    Server.oai_chat (load_mmproj, the PNG decoder, decode_wav, generate_mm
    on the engine's loop thread), the encoder against the CPU, the launches
    by part, the one-history parity; then a profiler window around one
    request (its trace must name kernel A) and a reload on an L2 file at
    the bench widths (one ffn_down overwritten: the logits of a fresh load,
    bit for bit)."""
    import base64
    from ik_llama_cpp_tpu_torch.models.clip import AudioEncoder, ClipEncoder
    from ik_llama_cpp_tpu_torch.runtime.media import decode_png, decode_wav
    from ik_llama_cpp_tpu_torch.server.app import Server, load_mmproj
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
    t_phase = time.perf_counter()
    ok = True
    t0 = time.perf_counter()
    vpath = build_mmproj_gguf(ROOT / "build" / "smoke_mmproj_clip.gguf", "vision")
    apath = build_mmproj_gguf(ROOT / "build" / "smoke_mmproj_whisper.gguf", "audio")
    files_s = time.perf_counter() - t0
    eng = BatchEngine(rt, n_slots=1, capacity=2048)
    srv = Server(eng, model_name="smoke8b", template="llama3")
    t0 = time.perf_counter()
    load_mmproj(srv, str(vpath))
    load_mmproj(srv, str(apath))
    sync(torch)
    load_s = time.perf_counter() - t0
    ok &= srv.props()["modalities"] == {"vision": True, "audio": True}
    log(f"[25] mmproj files ready in {files_s:.1f} s ({vpath.stat().st_size / 2**30:.2f} + "
        f"{apath.stat().st_size / 2**30:.2f} GiB f16), both towers loaded in {load_s:.1f} s; "
        f"modalities {srv.props()['modalities']}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    eng.start()
    try:
        png = smoke_png()
        img = decode_png(png)
        cpu = ClipEncoder(vpath, "cpu")
        part = {"type": "image_url",
                "image_url": {"url": "data:image/png;base64," + base64.b64encode(png).decode()}}
        torch.cuda.reset_peak_memory_stats()
        ok &= mm_case(torch, rt, srv, srv.clip, cpu, part, img, "vision", card)
        del cpu
        wav = smoke_wav(MM_AUDIO_S)
        cpu = AudioEncoder(apath, "cpu")
        part = {"type": "input_audio",
                "input_audio": {"data": base64.b64encode(wav).decode(), "format": "wav"}}
        torch.cuda.reset_peak_memory_stats()
        ok &= mm_case(torch, rt, srv, srv.audio, cpu, part, decode_wav(wav), "audio", card)
        del cpu
        # a torch.profiler window around one request, through the routes' methods
        trace_dir = ROOT / "build" / "trace25"
        start = srv.profiler_start({"dir": str(trace_dir)})
        srv.completion({"prompt": "the quick brown fox", "n_predict": 8, "temperature": 0.0})
        stop = srv.profiler_stop({})
        text = Path(stop["trace"]).read_text()
        named = "qmatmul_i8" in text
        ok &= start["success"] and stop["success"] and named
        log(f"[25] profiler routes: start {start}, stop wrote {Path(stop['trace']).name} "
            f"({len(text) / 2**20:.1f} MiB): kernel A named in the trace {named}: "
            f"{'ok' if named else 'FAIL'}")
    finally:
        eng.stop()
    del srv, eng
    torch.cuda.empty_cache()
    ok &= reload_check(torch)
    log(f"[25] multimodal path: {time.perf_counter() - t_phase:.1f} s in all")
    return bool(ok)


def build_reload_gguf(path: Path, down_seed: int) -> Path:
    """Two llama blocks at the bench widths (Q4_0 random blocks, a Q8_0
    tied head, a byte-level vocabulary), blk.0.ffn_down drawn from
    ``down_seed`` and all else from seed 0."""
    from ik_llama_cpp_tpu_torch.gguf.constants import GGMLType
    from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    w = GGUFWriter(str(path), arch="llama")
    for key, val in (("block_count", 2), ("context_length", 8192), ("embedding_length", E),
                     ("feed_forward_length", FF), ("attention.head_count", H),
                     ("attention.head_count_kv", HKV), ("attention.layer_norm_rms_epsilon", 1e-5),
                     ("rope.freq_base", 500000.0), ("rope.dimension_count", D), ("vocab_size", V)):
        w.add(f"llama.{key}", val)
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(V)])
    w.add("tokenizer.ggml.token_type", np.ones(V, np.int32))
    w.add("tokenizer.ggml.eos_token_id", 2)

    def q(name, rows, cols, ttype=GGMLType.Q4_0, gen=rng):
        w.add_tensor(name, _rand_blocks(gen, rows, cols, ttype), shape=(cols, rows),
                     ggml_type=ttype)

    q("token_embd.weight", V, E, GGMLType.Q8_0)
    w.add_tensor("output_norm.weight", np.ones(E, np.float32))
    for i in range(2):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", np.ones(E, np.float32))
        w.add_tensor(p + "ffn_norm.weight", np.ones(E, np.float32))
        for name, rows, cols in (("attn_q", E, E), ("attn_k", HKV * D, E), ("attn_v", HKV * D, E),
                                 ("attn_output", E, E), ("ffn_gate", FF, E), ("ffn_up", FF, E)):
            q(p + name + ".weight", rows, cols)
        down = np.random.default_rng(down_seed) if i == 0 else rng
        q(p + "ffn_down.weight", E, FF, gen=down)
    w.write()
    return path


def reload_check(torch) -> bool:
    """Runtime.reload_changed_tensors on a fresh L2 file at the bench
    widths: blk.0.ffn_down overwritten on disk, the reload patches that one
    leaf in place (the module object kept), and the logits over 64 ids
    equal a fresh load's of the new file bit for bit."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
    path = ROOT / "build" / "smoke_reload.gguf"
    t0 = time.perf_counter()
    build_reload_gguf(path, 1)
    rt = Runtime.from_gguf(path, track_reload=True)
    ids = [int(x) for x in np.random.default_rng(25).integers(3, V, 64)]
    before = rt.all_position_logits(ids)
    leaf = rt.params["blocks"][0]["ffn_down"]
    tmp = build_reload_gguf(path.with_suffix(".next"), 2)
    os.replace(tmp, path)
    t1 = time.perf_counter()
    changed = rt.reload_changed_tensors()
    sync(torch)
    reload_ms = (time.perf_counter() - t1) * 1e3
    after = rt.all_position_logits(ids)
    fresh = Runtime.from_gguf(path).all_position_logits(ids)
    in_place = rt.params["blocks"][0]["ffn_down"] is leaf
    moved = float((after - before).abs().max())
    same = bool(torch.equal(after, fresh))
    ok = changed and in_place and same and moved > 0
    log(f"[25] reload at the bench widths (L2): blk.0.ffn_down overwritten, reloaded in "
        f"{reload_ms:.1f} ms (in place: {in_place}); the logits moved by {moved:.3f} and equal a "
        f"fresh load's bit for bit: {same} ({time.perf_counter() - t0:.1f} s): "
        f"{'ok' if ok else 'FAIL'}")
    del rt
    torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default=",".join(str(p) for p in range(1, 26)))
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    if not (ROOT / "ik_llama_cpp_tpu_torch" / "csrc").is_dir():
        fail(f"the ik_llama_cpp_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from ik_llama_cpp_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    spent = {}                                   # seconds by phase, in run order

    def timed(label, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0

    dev = timed("1", phase_device, torch)
    timed("2", phase_build, _cuda)
    results, launches, ok = {}, {}, True
    timer = Timer(torch, reps=10)
    if 3 in phases:
        ok &= timed("3 quantizers", phase_quantizers, torch)
        ok &= timed("3 dense", phase_kernels, torch, timer, results)
        ok &= timed("3 moe i8", phase_moe_kernels, torch, timer, results)
        ok &= timed("3 kv quant", phase_kvq_kernels, torch, timer, results)
        ok &= timed("3 planar moe", phase_planar_moe_kernels, torch, timer, results)
        timed("3 flush", flush_verdict, timer)
    gguf = None
    if phases & {4, 5, 6, 9, 10, 11, 16, 20, 23, 25}:
        t0 = time.perf_counter()
        gguf = timed("4 file", build_gguf, ROOT / "build" / "smoke8b.gguf")
        log(f"[4] model file ready in {time.perf_counter() - t0:.1f} s: {gguf}")
    if 4 in phases:
        ok &= timed("4", phase_e2e, torch, gguf, launches)
    if 5 in phases:
        ok &= timed("5", phase_parity, torch, gguf)
    if 6 in phases:
        ok &= timed("6", phase_planar, torch, gguf, launches)
    if phases & {7, 8, 13, 14}:
        t0 = time.perf_counter()
        moe_gguf = timed("7 file", build_moe_gguf, ROOT / "build" / "smoke_qwen3moe.gguf")
        log(f"[7] model file ready in {time.perf_counter() - t0:.1f} s: {moe_gguf}")
        replay9 = {}
        ok &= timed("7, 8, 13c, 14", phase_moe, torch, moe_gguf, launches, phases,
                    replay=replay9)
        if 13 in phases:
            ok &= timed("13b", phase_planar_moe_parity, torch, moe_gguf)
        if 3 in phases and replay9:
            ok &= timed("3 9p", phase_replay_9p, torch, timer, results, replay9["sizes"],
                        replay9["chunk_ms"])
            ok &= timed("3 10p", phase_replay_10p, torch, timer, results, replay9["sizes"],
                        replay9["chunk_ms"])
    if 9 in phases:
        ok &= timed("9", phase_kvq, torch, gguf, launches)
    if 10 in phases:
        ok &= timed("10", phase_kvq_parity, torch, gguf)
    if 11 in phases:
        ok &= timed("11", phase_int4, torch, gguf, launches)
    if phases & {12, 13}:
        t0 = time.perf_counter()
        q2_gguf = timed("12 file", build_moe_gguf, ROOT / "build" / "smoke_qwen2moe.gguf", Q2MOE)
        log(f"[12] model file ready in {time.perf_counter() - t0:.1f} s: {q2_gguf}")
        replay = {}
        ok &= timed("12, 13a", phase_q2moe, torch, q2_gguf, launches, phases, replay=replay)
        if 3 in phases and replay:
            ok &= timed("3 14p", phase_replay_14p, torch, timer, results, replay["sizes"],
                        replay["chunk_ms"])
    if 15 in phases:
        ok &= timed("15", phase_perf_dequant, torch, launches)
    if phases & {16, 25}:
        # phase 25 runs on phase 16's loaded model
        ok &= timed("16", phase_server, torch, gguf, spent, phases, dev["smi"])
        spent["16"] -= spent.get("16b", 0.0) + spent.get("25", 0.0)   # logged on their own
    if 17 in phases:
        ok &= timed("17", phase_family, torch, launches)
    if 18 in phases:
        ok &= timed("18", phase_deepseek, torch, launches, dev["smi"])
    if 19 in phases:
        replay19 = {}
        ok &= timed("19", phase_qnext, torch, launches, dev["smi"], replay19)
        if 3 in phases and replay19:
            ok &= timed("3 9q", phase_replay_9p, torch, timer, results, replay19["sizes"],
                        replay19["chunk_ms"], QNEXT, "9q", "19")
    if 20 in phases:
        ok &= timed("20", phase_spec, torch, gguf, launches, dev["smi"])
    if 21 in phases:
        ok &= timed("21", phase_mtp, torch, launches, dev["smi"])
    if 22 in phases:
        ok &= timed("22", phase_mamba, torch, launches, dev["smi"])
    if 23 in phases:
        ok &= timed("23", phase_lora, torch, gguf, launches, dev["smi"])
    if 24 in phases:
        ok &= timed("24", phase_bert, torch, launches, dev["smi"])
    kernels = summary(results, launches)
    if phases >= {3, 4, 6, 7, 9, 11, 12, 14, 15, 16, 18, 19}:
        for k in kernels:
            if k["launches"] <= 0:
                log(f"chip_smoke: kernel {k['name']} was never launched on its path")
                ok = False
    log("[end] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    log(f"[end] total {time.perf_counter() - t_start:.1f} s")
    if not ok:
        fail("a phase failed (see above)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
