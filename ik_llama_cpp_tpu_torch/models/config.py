"""Model hyperparameters from GGUF metadata.

The TPU analogue of llm_load_hparams (src/llama.cpp:2593) + llama_hparams
(src/llama-hparams.h): every field read from the same `{arch}.*` GGUF keys
the reference reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from typing import Any


def _get(md: dict, arch: str, key: str, default=None):
    v = md.get(f"{arch}.{key}", default)
    if hasattr(v, "item") and getattr(v, "size", 1) == 1 \
            and getattr(v, "ndim", 0) == 0:
        v = v.item()
    return v


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_layer: int
    n_embd: int
    n_head: int
    n_head_kv: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    head_dim: int
    rms_eps: float = 1e-5
    rope_freq_base: float = 10000.0
    rope_type: int = 2  # NEOX default; llama family overrides to NORM
    rope_dim: int = 0   # rotary dims (0 = full head_dim)
    rope_scaling: str | None = None
    rope_scale_factor: float = 1.0
    rope_orig_ctx: int = 0
    # qk norms (qwen3, gemma3 style)
    use_qk_norm: bool = False
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    expert_gating_func: int = 1  # 1=softmax, 2=sigmoid (llama.h)
    n_ff_exp: int = 0
    n_ff_shexp: int = 0
    norm_topk_prob: bool = False
    expert_weights_scale: float = 1.0
    # MLA (deepseek2)
    n_lora_q: int = 0
    n_lora_kv: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_layer_dense_lead: int = 0
    n_expert_shared: int = 0
    expert_weights_norm: bool = False
    rope_yarn_log_mul: float = 0.0
    rope_attn_factor: float = 1.0
    # SSM (mamba family)
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    ssm_n_group: int = 0
    # misc
    f_logit_scale: float = 0.0
    f_attention_scale: float = 0.0
    tie_word_embeddings: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    swa_window: int = 0
    swa_pattern: int = 1  # every Nth layer is full-attention (gemma-style)
    # llama4 chunked attention: keys limited to the query's n_attn_chunk
    # block on layers selected by swa_layer_mask (llama-hparams.cpp:293-295)
    attn_chunk: int = 0
    qk_l2_norm: bool = False          # llama4 weightless Llama4TextL2Norm
    moe_weight_before: bool = False   # llama4: router weight scales the
                                      # expert INPUT (weight_before_ffn)
    # build_llama's MoE branch passes its NORMED ffn input as add_input to
    # llm_build_moe_ffn and never adds the raw ffn_inp (the add is commented
    # out, build_llama.cpp:191) — so mixtral/granitemoe/llama4 MoE layers
    # use the normed stream as the FFN residual
    moe_normed_residual: bool = False
    attn_temp_scale: float = 0.0      # llama4 NoPE-layer attn temperature
    attn_temp_floor: int = 8192
    # per-layer SWA mask (True = sliding window); empty = all layers SWA when
    # swa_window > 0. gemma2: even layers; gemma3: (il+1) % 6 != 0.
    swa_layer_mask: tuple = ()
    rope_freq_base_swa: float = 0.0   # rope base for SWA layers (gemma3: 1e4)
    embd_scale: float = 0.0           # input embedding scale (gemma: sqrt(E))
    act: str = "silu"                 # FFN activation: silu | gelu | relu2
    moe_act: str = "silu"             # MoE activation (gpt-oss: swiglu_oai)
    norm_type: str = "rms"            # rms | layer (starcoder2-style LN+bias)
    residual_scale: float = 0.0       # granite f_residual_scale
    no_rope_step: int = 0             # smollm3: skip rope every Nth layer
    parallel_residual: bool = False   # command-r: x + attn(n(x)) + ffn(n(x))
    par_res_separate_norm: bool = False  # gptneox use_par_res: ffn has its
                                         # own LN over the layer INPUT
    logit_scale_mul: bool = False     # command-r multiplies; granite divides
    nope_layer_mask: tuple = ()       # cohere2: no rope on global layers
    use_rope: bool = True             # gpt2/bloom/mpt/jais: no rope at all
    alibi_max_bias: float = 0.0       # ALiBi (bloom/mpt/jais/refact/baichuan-13b)
    clamp_kqv: float = 0.0            # mpt/olmo f_clamp_kqv
    residual_branch_scale: float = 0.0  # minicpm scale_res: scales each
                                        # branch OUTPUT before the add
    nextn_layers: int = 0             # glm4moe: trailing MTP layers skipped
                                      # in the main forward
    # per-layer overrides (deci/openelm); empty tuple = uniform.
    # n_head_arr[il]==0: attention-free layer; n_head_kv_arr[il]==0 with
    # heads: deci "linear attention" (wo only); n_ff_arr[il]==0: FFN-free
    n_head_arr: tuple = ()
    n_head_kv_arr: tuple = ()
    n_ff_arr: tuple = ()
    # -khad/-vhad (reference GGML_OP_HADAMARD, ggml-cuda/hadamard.cu):
    # Hadamard-rotate K (+q) / V before KV quantize-on-write
    k_hadamard: bool = False
    v_hadamard: bool = False
    extra: dict = field(default_factory=dict, hash=False, compare=False)

    def layer_is_swa(self, il: int) -> bool:
        if self.swa_window <= 0:
            return False
        if not self.swa_layer_mask:
            return True
        return bool(self.swa_layer_mask[il])

    @property
    def n_gqa(self) -> int:
        return self.n_head // max(self.n_head_kv, 1)


# archs whose GGUF weights use ggml NORM rope (consecutive-pair rotation);
# mirrors llama_rope_type (src/llama.cpp:8735-8781) — everything else is NEOX.
_NORM_ROPE_ARCHS = {
    "llama", "llama4", "deci", "baichuan", "starcoder", "plamo", "orion",
    "internlm2", "minicpm", "xverse", "command-r", "olmo", "arctic",
    "deepseek2", "deepseek4", "chatglm", "glm4", "granite", "granitemoe",
    "cohere2", "smollm3", "mistral3", "glm-dsa", "mistral4",
    "ernie4_5", "ernie4_5-moe", "cohere2_moe",
}


def _as_arr(v, n: int):
    """get_key_or_arr semantics: scalar broadcasts to n entries; an empty
    value stays empty; arrays pass through."""
    if v is None or (isinstance(v, (list, tuple)) and len(v) == 0):
        return []
    if isinstance(v, (list, tuple, np.ndarray)):
        return list(v)
    return [v] * n


def _step35_extra(a, n_layer, n_rot, swa_mask):
    """step35 per-layer arrays (llama-hparams.cpp:1586-1598)."""
    dims = a("rope.dimension_count_per_layer")
    if dims is not None and hasattr(dims, "__len__"):
        rope_arr = tuple(int(x) for x in dims)
    else:
        rope_arr = tuple(
            n_rot if (swa_mask and swa_mask[i]) else n_rot // 2
            for i in range(n_layer))
    lim = a("swiglu_limits")
    if lim is None:
        lim = a("swiglu_clamp_exp")
    lim_sh = a("swiglu_limits_shared")
    if lim_sh is None:
        lim_sh = a("swiglu_clamp_shexp")
    to_t = lambda v: tuple(float(x) for x in v) if v is not None and         hasattr(v, "__len__") else tuple([float(v or 0.0)] * n_layer)
    return {"rope_dim_arr": rope_arr, "swiglu_limits": to_t(lim),
            "swiglu_limits_shared": to_t(lim_sh)}


def config_from_gguf(md: dict[str, Any]) -> ModelConfig:
    arch = md["general.architecture"]
    a = lambda key, default=None: _get(md, arch, key, default)

    n_embd = int(a("embedding_length"))

    def _maybe_arr(key, default=None):
        """deci/openelm store per-layer arrays under the scalar keys."""
        v = a(key, default)
        if v is not None and hasattr(v, "__len__") and not isinstance(v, str):
            return tuple(int(x) for x in v), int(max(int(x) for x in v))
        return (), (None if v is None else int(v))

    if arch in ("qwen3vl", "qwen3vlmoe"):
        # vision deepstack features stack along the feature dim; the text
        # stream uses the main slice (build_qwen3vl: n_embd_full /
        # (n_deepstack_layers + 1))
        n_embd = n_embd // (1 + int(a("n_deepstack_layers", 0)))
    n_head_arr, n_head = _maybe_arr("attention.head_count")
    n_head_kv_arr, n_head_kv = _maybe_arr("attention.head_count_kv", n_head)
    if n_head_kv is None:
        n_head_kv = n_head
    head_dim = int(a("attention.key_length", n_embd // max(n_head, 1)))
    n_vocab = int(a("vocab_size", 0)) or len(md.get("tokenizer.ggml.tokens", []))
    n_layer = int(a("block_count"))

    rope_type = 0 if arch in _NORM_ROPE_ARCHS else 2
    scaling = a("rope.scaling.type")

    # per-arch structural defaults, mirroring llm_load_hparams
    # (src/llama-hparams.cpp:805-850) and the per-arch graph builders
    embd_scale, act = 0.0, "silu"
    swa_mask: tuple = ()
    attn_softcap = float(a("attn_logit_softcapping", 0.0))
    final_softcap = float(a("final_logit_softcapping", 0.0))
    swa_window = int(a("attention.sliding_window", 0))
    f_attn_scale = float(a("attention.scale", 0.0))
    rope_base_swa = 0.0
    qk_norm = arch in ("qwen3", "qwen3moe", "qwen3next", "qwen3vl",
                   "qwen3vlmoe")
    if arch in ("gemma", "gemma2", "gemma3"):
        embd_scale = float(n_embd) ** 0.5
        act = "gelu"
    if arch == "gemma2":
        swa_window = swa_window or 4096
        attn_softcap = attn_softcap or 30.0
        final_softcap = final_softcap or 30.0
        swa_mask = tuple(il % 2 == 0 for il in range(n_layer))
        # build_gemma2.cpp: 27B (46 layers) scales Q by 1/sqrt(E/H)
        f_attn_scale = (1.0 / (n_embd / max(n_head, 1)) ** 0.5 if n_layer == 46
                        else 1.0 / float(head_dim) ** 0.5)
    elif arch == "gemma3":
        qk_norm = True
        swa_mask = tuple((il + 1) % 6 != 0 for il in range(n_layer))
        rope_base_swa = 10000.0
        f_attn_scale = (1.0 / (n_embd / max(n_head, 1)) ** 0.5 if n_layer == 62
                        else 1.0 / float(head_dim) ** 0.5)
    elif arch == "gemma4":
        # gemma-3n style: raw scores (f_attention_scale = 1.0), softcap 30,
        # SWA pattern from the per-layer KV (llama-hparams.cpp:851-877)
        qk_norm = True
        rope_base_swa = 10000.0
        final_softcap = float(a("final_logit_softcapping", 30.0))
        f_attn_scale = 1.0
    elif arch in ("gemma4_mtp", "gemma4-assistant"):
        # gemma4 MTP/assistant draft tier (llama-hparams.cpp:878-905):
        # raw scores, no softcap, SWA pattern + eps read normally
        qk_norm = True
        rope_base_swa = 10000.0
        f_attn_scale = 1.0
    moe_act = "silu"
    norm_type = "rms"
    residual_scale = 0.0
    no_rope_step = 0
    moe_weight_before = False
    moe_normed_residual = arch in ("llama", "llama4", "granite",
                                   "granitemoe", "mixtral")
    attn_chunk = 0
    qk_l2 = False
    attn_temp_scale = 0.0
    attn_temp_floor = 8192
    expert_gating = int(a("expert_gating_func", 1))
    if arch == "llama4":
        # 3 chunked + 1 full attention pattern, NoPE every 4th layer,
        # sigmoid MoE routing, weightless qk L2 norm on the 16E model,
        # attention temperature on NoPE layers (llama-hparams.cpp:288-305;
        # build_llama.cpp LLM_ARCH_LLAMA4 branches)
        no_rope_step = 4
        attn_chunk = int(a("attention.chunk_size", 8192))
        swa_mask = tuple(il % 4 < 3 for il in range(n_layer))
        # NOTE: the reference fork's Llama4TextL2Norm block is dead code
        # (guarded by use_rope inside the NoPE-only branch,
        # build_llama.cpp:52-95) — no qk norm is ever applied; match that
        qk_l2 = False
        attn_temp_scale = float(a("attention.temperature_scale", 0.1))
        attn_temp_floor = int(a("attention.temperature_length", 8192))
        expert_gating = 2
        moe_weight_before = True
    if arch in ("granite", "granitemoe"):
        # granite multipliers (llama-hparams.cpp:1344-1351; build_llama.cpp
        # residual/embedding/logit scaling)
        residual_scale = float(a("residual_scale", 1.0))
        embd_scale = float(a("embedding_scale", 1.0))
        f_attn_scale = float(a("attention.scale", 0.0))
    elif arch == "smollm3":
        no_rope_step = 4      # llama-hparams.cpp:1496
    elif arch == "starcoder2":
        norm_type = "layer"
        act = "gelu"
    parallel_residual = False
    logit_mul = False
    nope_mask: tuple = ()
    if arch == "command-r":
        # build_command_r.cpp: one shared LayerNorm feeds BOTH the attention
        # and the FFN; their outputs add into the residual together
        norm_type = "layer"
        parallel_residual = True
        logit_mul = True
    elif arch == "cohere2":
        # build_cohere2.cpp: command-r structure + 3:1 SWA pattern with NoPE
        # on the global (non-sliding) layers
        norm_type = "layer"
        parallel_residual = True
        logit_mul = True
        swa_window = swa_window or 4096
        swa_mask = tuple(il % 4 < 3 for il in range(n_layer))
        nope_mask = tuple(not (il % 4 < 3) for il in range(n_layer))
    use_rope = True
    n_ff_override = None
    alibi_bias = 0.0
    clamp_kqv = 0.0
    par_sep = False
    branch_scale = 0.0
    logit_scale = float(a("logit_scale", 0.0))
    nextn = 0
    # classic-family defaults, mirroring llm_load_hparams per-arch cases
    # (llama-hparams.cpp) and the graph builders in src/graphs/
    if arch in ("gpt2", "starcoder", "codeshell", "bloom", "mpt", "jais",
                "gptneox", "falcon", "phi2", "stablelm", "orion"):
        norm_type = "layer"
    if arch in ("gpt2", "starcoder", "codeshell", "bloom", "mpt",
                "gptneox", "falcon", "phi2"):
        act = "gelu"
    if arch in ("gpt2", "bloom", "mpt", "jais", "refact", "starcoder"):
        # build_gpt2/bloom/mpt/jais/refact/starcoder: no rope in the graph
        # (llama_rope_type: ROPE_TYPE_NONE; starcoder uses learned pos embd)
        use_rope = False
    if arch in ("bloom", "refact", "jina-bert-v2"):
        alibi_bias = 8.0          # llama-hparams.cpp hardcodes 8.0 (:431 jina)
    elif arch == "mpt":
        alibi_bias = float(a("attention.max_alibi_bias", 0.0))
        clamp_kqv = float(a("attention.clamp_kqv", 0.0))
    elif arch == "jais":
        alibi_bias = float(a("attention.max_alibi_bias", 8.0))
        # build_jais.cpp:46: kq scale is 1/n_embd_head, not 1/sqrt
        f_attn_scale = 1.0 / float(head_dim)
    elif arch == "olmo":
        clamp_kqv = float(a("attention.clamp_kqv", 0.0))
        norm_type = "layer"       # non-parametric LN (no norm tensors)
    elif arch == "gptneox":
        # build_gptneox.cpp use_par_res: x + attn(ln1(x)) + ffn(ln2(x))
        parallel_residual = bool(a("use_parallel_residual", True))
        par_sep = True
    elif arch in ("falcon", "phi2"):
        # build_falcon.cpp / build_phi2.cpp: FFN reads the attn-norm output;
        # both branches add into the residual together
        parallel_residual = True
    elif arch == "baichuan" and n_layer == 40:
        # 13B variant: ALiBi instead of rope (llama-hparams.cpp:377-380)
        use_rope = False
        alibi_bias = 8.0
    elif arch == "minicpm":
        # build_minicpm.cpp hardcoded multipliers
        embd_scale = 12.0
        branch_scale = 1.4 / float(n_layer) ** 0.5
        logit_scale = 256.0 / float(n_embd)
        logit_mul = True
    elif arch == "qwen":
        # qwen1 GGUFs store DOUBLE the FFN width (create_qwen_tensors
        # passes n_ff/2 to create_std_ffn)
        n_ff_override = int(a("feed_forward_length", 0)) // 2
    elif arch in ("bitnet-25", "bitnet-b1.58"):
        act = "relu2"        # build_bitnet_158: LLM_FFN_RELU_SQR
    elif arch == "deci":
        # Nemotron: per-branch residual scale + logit divide (build_deci.cpp)
        branch_scale = float(a("residual_scale", 0.0))
    elif arch == "dbrx":
        norm_type = "layer"          # LN without biases (create_dbrx_tensors)
        clamp_kqv = float(a("attention.clamp_kqv", 0.0))
    elif arch == "grok":
        # llama-hparams.cpp:326-348 defaults for old GGUFs
        embd_scale = float(a("embedding_scale", 78.38367176906169))
        logit_scale = float(a("logit_scale", 0.5773502691896257))
        logit_mul = True
        # kq scale 1.0 with attn_out_scale folded into the softcap
        # (llama-build-context.cpp:2103)
        f_attn_scale = float(a("attention.output_scale", 0.08838834764831845))
        attn_softcap = attn_softcap or 30.0
        final_softcap = final_softcap or 30.0
        act = "gelu"
        moe_act = "gelu"
    elif arch == "plamo":
        # build_plamo.cpp: shared-norm parallel residual (x + attn + ffn(h));
        # its ffn_norm tensor is loaded but unused by the graph
        parallel_residual = True
    elif arch == "minimax-m3":
        # build_minimaxm3.cpp: SWIGLU_OAI activation for dense and experts
        act = "swiglu_oai"
        moe_act = "swiglu_oai"
    elif arch in ("glm4moe", "bailingmoe2", "qwen35", "qwen35moe", "step35"):
        # trailing NextN/MTP layers are loaded but not run in the main
        # forward (build_glm4.cpp n_transformer_layers)
        nextn = int(a("nextn_predict_layers", 0))
        n_layer = n_layer - nextn
    elif arch == "mimo2":
        # build_mimo2.cpp hardcodes SIGMOID routing regardless of KV.
        # (cohere2_moe/step35's "default to sigmoid when NONE" hparams code
        # is dead — the field default is SOFTMAX, so absent KV means softmax)
        expert_gating = 2
    if arch == "cohere2_moe":
        # command-r-style shared-norm parallel residual, RMS norms,
        # logit multiply on the final hidden state (build_cohere2_moe.cpp)
        parallel_residual = True
        logit_mul = True
    if arch == "mellum" and swa_window > 0 and not swa_mask:
        # default 3:1 SWA pattern when no explicit pattern KV
        # (llama-hparams.cpp:575-578)
        swa_mask = tuple((il + 1) % 4 != 0 for il in range(n_layer))
    # generic per-layer SWA pattern: bool array, or integer N meaning
    # "every Nth layer is global" ((il+1) % N != 0 -> sliding)
    _pat = a("attention.sliding_window_pattern")
    if swa_window > 0 and _pat is not None:
        if hasattr(_pat, "__len__"):
            swa_mask = tuple(bool(int(x)) for x in _pat)
        else:
            swa_mask = tuple((il + 1) % int(_pat) != 0 for il in range(n_layer))
    if arch == "openpangu":
        # DSA/SWA schedule: swa_layers ids + per-entry windows
        # (llama-hparams.cpp:1178-1204); absent keys = dense fallback
        _ids = a("swa_layers")
        _wins = a("sliding_window_list")
        if _ids is not None and _wins is not None and \
                len(_ids) == len(_wins):
            _m = [False] * n_layer
            for _il, _w in zip(_ids, _wins):
                if int(_il) < n_layer and int(_w) > 0:
                    _m[int(_il)] = True
                    swa_window = int(_w)
            swa_mask = tuple(_m)
    rope_base_swa = float(a("rope.freq_base_swa", rope_base_swa or 0.0))
    if arch == "cohere2_moe" and swa_mask:
        # NoPE on the global (non-sliding) layers, like cohere2
        nope_mask = tuple(not m for m in swa_mask)
    if arch == "laguna":
        # step35-layout (create_step35_tensors reused,
        # llama-load-tensors.cpp:5006) + softplus attn gate; sigmoid routing
        # by default; XS.2 marks SWA layers via differing per-layer head
        # counts (llama-hparams.cpp:1612-1676)
        if expert_gating == 0 or not a("expert_gating_func"):
            expert_gating = 2
        if swa_window > 0 and not swa_mask and n_head_arr:
            swa_mask = tuple(h0 != n_head_arr[0] for h0 in n_head_arr)
    if arch == "step35":
        # per-layer SWA pattern + per-layer rope dims (default: full n_rot on
        # SWA layers, half on global) + per-layer clamped-swiglu limits;
        # sigmoid routing by default (llama-hparams.cpp:1564-1605)
        if expert_gating == 0 or not a("expert_gating_func"):
            expert_gating = 2
    if arch == "gpt-oss":
        # build_openai.cpp: even layers SWA (pattern 2), per-head sinks,
        # softmax-over-topk routing, clamped swiglu_oai experts
        swa_mask = tuple(il % 2 == 0 for il in range(n_layer))
        moe_act = "swiglu_oai"
        expert_gating = 3     # GATING_SOFTMAX_WEIGHT
        rope_dim_key = int(a("rope.dimension_count", head_dim))
        f_attn_scale = f_attn_scale or 1.0 / float(rope_dim_key) ** 0.5

    return ModelConfig(
        arch=arch,
        n_layer=n_layer,
        n_embd=n_embd,
        n_head=n_head,
        n_head_kv=n_head_kv,
        n_ff=(n_ff_override if n_ff_override is not None
              else _maybe_arr("feed_forward_length", 0)[1]),
        n_ff_arr=_maybe_arr("feed_forward_length", 0)[0],
        n_head_arr=n_head_arr,
        n_head_kv_arr=n_head_kv_arr,
        n_vocab=n_vocab,
        n_ctx_train=int(a("context_length", 4096)),
        head_dim=head_dim,
        rms_eps=float(a("attention.layer_norm_rms_epsilon",
                        a("attention.layer_norm_epsilon", 1e-5))),
        rope_freq_base=float(a("rope.freq_base", 10000.0)),
        rope_type=rope_type,
        rope_dim=int(a("rope.dimension_count", head_dim)),
        rope_scaling=scaling,
        rope_scale_factor=float(a("rope.scaling.factor", 1.0)),
        rope_orig_ctx=int(a("rope.scaling.original_context_length", 0)),
        use_qk_norm=qk_norm,
        n_expert=int(a("expert_count", 0)),
        n_expert_used=int(a("expert_used_count", 0)),
        expert_gating_func=expert_gating,
        n_ff_exp=int(a("expert_feed_forward_length", 0)),
        n_ff_shexp=int(a("expert_shared_feed_forward_length", 0)),
        norm_topk_prob=bool(a("norm_topk_prob", arch in (
            # builders that hardcode norm_w=true in their moe_ffn call
            "qwen3moe", "hunyuan-moe", "mellum", "mimo2", "dbrx", "grok",
            "arctic", "minimax-m2", "ernie4_5-moe", "granitemoe",
            "mixtral", "llama",     # "llama" = mixtral ggufs (moe-only)
            "qwen3vlmoe"))),
        expert_weights_scale=float(a("expert_weights_scale", 1.0)),
        n_lora_q=int(a("attention.q_lora_rank", 0) or 0),
        n_lora_kv=int(a("attention.kv_lora_rank", 0) or 0),
        qk_nope_head_dim=max(0, head_dim - int(a("rope.dimension_count", head_dim))),
        qk_rope_head_dim=int(a("rope.dimension_count", 0) or 0),
        v_head_dim=int(a("attention.value_length", head_dim)),
        n_layer_dense_lead=int(a("leading_dense_block_count", 0)),
        n_expert_shared=int(a("expert_shared_count", 0)),
        expert_weights_norm=bool(a("expert_weights_norm", False)),
        rope_yarn_log_mul=float(a("rope.scaling.yarn_log_multiplier", 0.0)),
        rope_attn_factor=float(a("rope.scaling.attn_factor", 1.0)),
        ssm_d_conv=int(a("ssm.conv_kernel", 0)),
        ssm_d_inner=int(a("ssm.inner_size", 0)),
        ssm_d_state=int(a("ssm.state_size", 0)),
        ssm_dt_rank=int(a("ssm.time_step_rank", 0)),
        ssm_n_group=int(a("ssm.group_count", 0)),
        f_logit_scale=logit_scale,
        f_attention_scale=f_attn_scale,
        attn_softcap=attn_softcap,
        final_softcap=final_softcap,
        swa_window=swa_window,
        swa_layer_mask=swa_mask,
        rope_freq_base_swa=rope_base_swa,
        embd_scale=embd_scale,
        act=act,
        moe_act=moe_act,
        norm_type=norm_type,
        residual_scale=residual_scale,
        no_rope_step=no_rope_step,
        parallel_residual=parallel_residual,
        par_res_separate_norm=par_sep,
        logit_scale_mul=logit_mul,
        nope_layer_mask=nope_mask,
        attn_chunk=attn_chunk,
        qk_l2_norm=qk_l2,
        moe_weight_before=moe_weight_before,
        moe_normed_residual=moe_normed_residual,
        attn_temp_scale=attn_temp_scale,
        attn_temp_floor=attn_temp_floor,
        extra=(_step35_extra(a, n_layer, head_dim, swa_mask)
               if arch == "step35" else
               # laguna per-layer rope dims (llama-hparams.cpp:1643-1670):
               # full-attn layers rotate n_rot (default head/2), SWA layers
               # n_rot_swa (default full head)
               {"rope_dim_arr":
                tuple(int(x) for x in a("rope.dimension_count_per_layer"))
                if a("rope.dimension_count_per_layer") is not None else
                tuple(
                   int(a("rope.dimension_count_swa", head_dim))
                   if (swa_mask and swa_mask[i])
                   else int(a("rope.dimension_count", head_dim // 2))
                   for i in range(n_layer))}
               if arch == "laguna" else
               {"n_rel_attn_bkts": int(a("attention.relative_buckets_count", 32)),
                "dec_start": int(a("decoder_start_token_id", -1))}
               if arch in ("t5", "t5encoder") else
               {"full_attn_interval": int(a("full_attention_interval", 4)),
                # imrope (LLAMA_ROPE_TYPE_IMROPE, llama.cpp:8832) sections
                "rope_sections": [int(v) for v in a("rope.dimension_sections", [])]}
               if arch in ("qwen35", "qwen35moe", "qwen3next") else
               # qwen3vl: imrope sections + deepstack feature stacking (the
               # metadata n_embd is main*(deepstack+1); text mode uses main)
               {"rope_sections": [int(v) for v in
                                  a("rope.dimension_sections", [])],
                "n_deepstack": int(a("n_deepstack_layers", 0))}
               if arch in ("qwen3vl", "qwen3vlmoe") else
               # gemma4 (llama-hparams.cpp:851-877): trailing shared-KV
               # layers, per-type head dims, per-layer-input embeddings
               {"n_kv_layers": n_layer - int(a("attention.shared_kv_layers",
                                               0)),
                "head_dim_swa": int(a("attention.key_length_swa", head_dim)),
                "n_rot_swa": int(a("rope.dimension_count_swa",
                                   a("rope.dimension_count", head_dim))),
                "n_embd_per_layer": int(
                    a("embedding_length_per_layer_input", 0))}
               if arch == "gemma4" else
               # gemma4 MTP / assistant draft (llama-hparams.cpp:878-905);
               # the assistant spells its keys gemma4-assistant.*_out /
               # n_centroids — a() prefixes the arch either way
               {"mtp_backbone_n_embd": int(
                   a("backbone_embedding_length",
                     a("embedding_length_out", 0))),
                "mtp_num_centroids": int(a("centroid_count",
                                           a("n_centroids", 0))),
                "mtp_centroid_top_k": int(a("centroid_top_k", 0)),
                "mtp_use_ordered_embeddings": bool(
                    a("use_ordered_embeddings", False))}
               if arch in ("gemma4_mtp", "gemma4-assistant") else
               # dflash draft metadata (llama-hparams.cpp:905-927)
               {"block_size": int(a("dflash.block_size", 8)),
                "mask_token_id": int(a("dflash.mask_token_id", 0)),
                "n_target_features": int(a("dflash.n_target_features", 0)),
                "target_layer_ids": [int(v) for v in
                                     a("dflash.target_layer_ids", [])],
                "backbone_rotary_base": float(
                    a("dflash.backbone_rotary_base", 0.0)),
                "attn_v_scale": float(a("attention.value_scale", 1.0)),
                "laguna": bool(a("dflash.laguna", False))}
               if arch == "dflash-draft" else
               # DeepSeek-V4 (llama-hparams.cpp LLM_ARCH_DEEPSEEK4 case):
               # hyper-connections, CSA/HCA compressor ratios, LID indexer,
               # per-layer swiglu clamps
               {"hc_mult": int(a("hyper_connection.count", 1) or 1),
                "hc_sinkhorn_iters": int(
                    a("hyper_connection.sinkhorn_iterations", 3)),
                "hc_eps": float(a("hyper_connection.epsilon",
                                  a("attention.layer_norm_rms_epsilon",
                                    1e-5))),
                "compress_ratios": [int(v) for v in _as_arr(
                    a("attention.compress_ratios", []), n_layer)],
                "compress_rope_base": float(
                    a("attention.compress_rope_freq_base",
                      a("rope.freq_base_swa", a("rope.freq_base", 1e4)))),
                "indexer_n_head": int(a("attention.indexer.head_count", 0)),
                "indexer_head_size": int(a("attention.indexer.key_length",
                                           0)),
                "indexer_top_k": int(a("attention.indexer.top_k", 0)),
                "swiglu_limits": [float(v) for v in _as_arr(
                    a("swiglu_clamp_exp", []), n_layer)],
                "swiglu_limits_shared": [float(v) for v in _as_arr(
                    a("swiglu_clamp_shexp", a("swiglu_clamp_exp", [])),
                    n_layer)],
                "hash_layer_count": int(a("hash_layer_count", 0)),
                "nextn_predict_layers": int(a("nextn_predict_layers", 0))}
               if arch == "deepseek4" else
               # GLM-DSA lightning indexer (llama-hparams.cpp:1790-1860):
               # IndexShare full-layer rule (il<=1 or il%4==2); dsa_enabled
               # turns the sparse top-k path on by default whenever the
               # indexer tensors exist (the reference gates it behind --dsa)
               {"indexer_n_head": int(a("attention.indexer.head_count", 0)),
                "indexer_head_size": int(a("attention.indexer.key_length",
                                           0)),
                "indexer_top_k": int(a("attention.indexer.top_k", 2048)),
                "indexer_is_full": tuple(
                    (il <= 1) or (il % 4 == 2) for il in range(n_layer)),
                "dsa_enabled": True}
               if arch == "glm-dsa" else
               # openPangu (llama-hparams.cpp:1144-1226): mHC streams,
               # Sinkhorn iters, learned param sinks, optional DSA indexer
               {"mhc_num_stream": int(a("mhc_num_stream", 4)),
                "mhc_recur_norm": int(a("mhc_recur_norm", 20)),
                "param_sink_number": int(a("param_sink_number", 0)),
                "indexer_n_head": int(a("attention.indexer.head_count", 0)),
                "indexer_head_size": int(a("attention.indexer.key_length",
                                           0)),
                "indexer_top_k": int(a("attention.indexer.top_k", 0))}
               if arch == "openpangu" else {}),
        use_rope=use_rope,
        alibi_max_bias=alibi_bias,
        clamp_kqv=clamp_kqv,
        residual_branch_scale=branch_scale,
        nextn_layers=nextn,
    )
