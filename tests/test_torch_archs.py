"""The dense family on the llama graph, in the port against the JAX package
on the CPU: gemma/2/3, phi3, qwen2/3 (and their vl text forms), mistral,
the llama-likes, starcoder2, deci, openelm and bitnet.

Each case builds its tiny GGUF (2-4 layers, width 64) with the JAX
package's fixtures, loads it through both packages' ``Runtime.from_gguf``,
and runs the eager forward of each over a 20-token prompt and then three
decode steps fed the same tokens (one token history): every position's
logits must agree within 2% of the largest logit. The two forwards are the
same operations in the same order; what differs is where bf16 rounds the
residual stream and the cache (observed: at most 1e-2 of the largest
logit, most cases 1e-7). The helpers here serve the other family files
(test_torch_classic_archs.py, test_torch_moe_archs.py)."""
from dataclasses import asdict
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.runtime import generate as TG

N_PROMPT, STEPS, TOL = 20, 3, 2e-2


def rewrite(src, dst, *, arch: str | None = None, rename: dict | None = None,
            drop=(), extra_kv: dict | None = None, extra: dict | None = None) -> Path:
    """src's metadata and tensors written to dst: under another
    architecture name (its keys renamed with it), with tensor names
    substituted by ``rename``, the tensors whose name holds a ``drop`` entry
    left out, and ``extra_kv`` / ``extra`` (name -> float32 array) added."""
    m = t_load_gguf(src)
    old = m.metadata["general.architecture"]
    w = GGUFWriter(dst)
    for key, val in m.metadata.items():
        if arch and key == "general.architecture":
            val = arch
        elif arch and key.startswith(old + "."):
            key = arch + key[len(old):]
        w.add(key, val)
    for key, val in (extra_kv or {}).items():
        w.add(key, val)
    for name, info in m.tensors.items():
        if any(d in name for d in drop):
            continue
        for a, b in (rename or {}).items():
            name = name.replace(a, b)
        w.add_tensor(name, info.data, shape=info.shape, ggml_type=info.ggml_type)
    for name, arr in (extra or {}).items():
        w.add_tensor(name, arr)
    w.write()
    return Path(dst)


def forwards(jr, tr, ids, *, jkv=None, tkv=None, n_prompt: int = N_PROMPT, capacity: int = 64):
    """The eager JAX forward's and the port's logits (n, V) over ``ids``:
    the first ``n_prompt`` as one chunk, then one token a step."""
    jkv = JG.CACHES[jr.cfg.arch](jr.cfg, 1, capacity) if jkv is None else jkv
    tkv = TLM.KVCache.create(tr.cfg, 1, capacity, "cpu") if tkv is None else tkv
    js, ts, n = [], [], 0
    for chunk in [ids[:n_prompt]] + [ids[i:i + 1] for i in range(n_prompt, len(ids))]:
        tok = np.asarray(chunk, np.int32)[None]
        jl, jkv = JLM.forward(jr.params, jr.cfg, jnp.asarray(tok), jkv, jnp.int32(n))
        tl = TLM.forward(tr.params, tr.cfg, torch.from_numpy(tok).long(), tkv, n)
        js.append(np.asarray(jl[0]))
        ts.append(tl[0].numpy())
        n += len(chunk)
    return np.concatenate(js), np.concatenate(ts)


def check_arch(path, seed: int = 0, tol: float = TOL):
    """Load ``path`` through both runtimes and hold the port's logits to the
    JAX package's over one token history. Returns both runtimes and both
    logits."""
    jr = JG.Runtime.from_gguf(path)
    tr = TG.Runtime.from_gguf(path, device="cpu")
    assert asdict(tr.cfg) == asdict(jr.cfg)
    ids = [int(x) for x in np.random.default_rng(seed).integers(
        3, min(250, tr.cfg.n_vocab), N_PROMPT + STEPS)]
    jl, tl = forwards(jr, tr, ids)
    scale = float(np.abs(jl).max())
    assert np.isfinite(tl).all()
    err = float(np.abs(tl - jl).max())
    assert err <= tol * scale, f"max |port - JAX| {err:.3e} > {tol} * {scale:.3f}"
    return jr, tr, jl, tl


L = F.make_tiny_llamalike_gguf
SECTIONS = np.asarray([4, 2, 2, 0], np.int32)
CASES = {
    "llama": lambda p: L(p, arch="llama"),
    "qwen2": lambda p: L(p, arch="qwen2", attn_bias=True),
    "qwen3": lambda p: L(p, arch="qwen3", qk_norm=True),
    "qwen2vl": lambda p: L(p, arch="qwen2vl", attn_bias=True,
                           extra_kv={"qwen2vl.rope.dimension_sections": SECTIONS}),
    "qwen3vl": lambda p: L(p, arch="qwen3vl", qk_norm=True,
                           extra_kv={"qwen3vl.rope.dimension_sections": SECTIONS}),
    "mistral": lambda p: L(p, arch="mistral"),
    "mistral3": lambda p: L(p, arch="mistral3"),
    "internlm2": lambda p: L(p, arch="internlm2"),
    "exaone": lambda p: L(p, arch="exaone"),
    "ernie4_5": lambda p: L(p, arch="ernie4_5"),
    "plamo": lambda p: L(p, arch="plamo"),
    "smollm3": lambda p: L(p, arch="smollm3", n_layer=4),         # NoPE every 4th layer
    "granite": lambda p: L(p, arch="granite", extra_kv={
        "granite.embedding_scale": 2.0, "granite.residual_scale": 0.5,
        "granite.attention.scale": 0.08, "granite.logit_scale": 4.0}),
    "command-r": lambda p: L(p, arch="command-r", ffn_norm=False, eps_key="layer",
                             tied=True, extra_kv={"command-r.logit_scale": 0.5}),
    "cohere2": lambda p: L(p, arch="cohere2", n_layer=4, ffn_norm=False, eps_key="layer",
                           tied=True, extra_kv={"cohere2.logit_scale": 0.25,
                                                "cohere2.attention.sliding_window": 16,
                                                "cohere2.rope.scaling.type": "none"}),
    # seed_oss stores its pre-FFN norm as post_attention_norm
    "seed_oss": lambda p: rewrite(L(f"{p}.src", arch="seed_oss"), p,
                                  rename={"ffn_norm": "post_attention_norm"}),
    "gemma": lambda p: F.make_tiny_llama_gguf(p, arch="gemma"),
    "gemma2": lambda p: F.make_tiny_gemma_gguf(p, version=2),
    "gemma3": lambda p: F.make_tiny_gemma_gguf(p, version=3),
    "phi3": lambda p: F.make_tiny_phi3_gguf(p),
    "starcoder2": lambda p: F.make_tiny_starcoder2_gguf(p),
    "deci": lambda p: F.make_tiny_deci_gguf(p),
    "openelm": lambda p: F.make_tiny_openelm_gguf(p),
    "bitnet": lambda p: F.make_tiny_bitnet_gguf(p, arch="bitnet"),
    "bitnet-25": lambda p: F.make_tiny_bitnet_gguf(p, arch="bitnet-25"),
    "bitnet-b1.58": lambda p: F.make_tiny_bitnet_gguf(p, arch="bitnet-b1.58"),
}


@pytest.mark.parametrize("arch", list(CASES))
def test_arch_matches_jax(tmp_path, arch):
    jr, tr, _, _ = check_arch(CASES[arch](tmp_path / f"{arch}.gguf"))
    assert tr.cfg.arch == arch


def test_family_is_the_jax_runtimes():
    """The port runs exactly the JAX runtime's dense family on the llama
    graph, and the three family files hold every one of them."""
    import test_torch_classic_archs as C
    import test_torch_moe_archs as MO
    assert set(TLM.ARCHS) == set(JG._DENSE_FAMILY)
    assert all(TG.FORWARDS[a] is TLM.forward for a in TLM.ARCHS)
    assert set(CASES) | set(C.CASES) | set(MO.CASES) == set(JG._DENSE_FAMILY)


def test_gptj_raises_in_both(tmp_path):
    path = L(tmp_path / "gptj.gguf", arch="gptj")
    with pytest.raises(NotImplementedError, match="gptj is vestigial"):
        JG.Runtime.from_gguf(path)
    with pytest.raises(NotImplementedError, match="gptj is vestigial"):
        TG.Runtime.from_gguf(path, device="cpu")


def test_own_forward_archs_name_their_queue_item(tmp_path):
    """An architecture with a forward of its own in the JAX package (here
    t5; mamba and bert were until they were ported) is refused with its
    queue item, at the runtime and the loader."""
    path = F.make_tiny_t5_gguf(tmp_path / "t5.gguf")
    with pytest.raises(NotImplementedError, match=r"t5.*item 8"):
        TG.Runtime.from_gguf(path, device="cpu")
    tg = t_load_gguf(path)
    from ik_llama_cpp_tpu_torch.models.config import config_from_gguf
    with pytest.raises(NotImplementedError, match=r"item 8"):
        TLM.load_llama_params(tg, config_from_gguf(tg.metadata), "cpu")


def test_rms_norm_bias_is_refused(tmp_path):
    """A norm bias the graph would not apply (RMS norms) stops the load,
    where the JAX loader takes it and drops it."""
    src = L(tmp_path / "src.gguf", arch="qwen2")
    path = rewrite(src, tmp_path / "nb.gguf",
                   extra={"blk.0.ffn_norm.bias": np.ones(64, np.float32)})
    with pytest.raises(NotImplementedError, match=r"blk\.0\.ffn_norm\.bias"):
        TG.Runtime.from_gguf(path, device="cpu")


def test_mtp_blocks_are_loaded_not_run(tmp_path):
    """A trailing NextN block goes into params["mtp_blocks"] with the glue
    the JAX loader takes, and the main stack keeps block_count layers. Its
    forward runs since the speculative slice (held to the JAX package in
    test_torch_mtp.py); the forward's per-layer hiddens still name their
    queue item."""
    path = F.make_tiny_moe2_gguf(tmp_path / "nx.gguf", arch="glm4moe", nextn=1)
    jr = JG.Runtime.from_gguf(path)
    tr = TG.Runtime.from_gguf(path, device="cpu")
    assert tr.cfg.nextn_layers == 1 and len(tr.params["blocks"]) == tr.cfg.n_layer
    (jm,), (tm,) = jr.params["mtp_blocks"], tr.params["mtp_blocks"]
    assert set(tm) == set(jm) and {"eh_proj", "enorm", "hnorm"} <= set(tm)
    np.testing.assert_array_equal(tm["enorm"].numpy(), np.asarray(jm["enorm"]))
    lg, _, hid = TLM.mtp_forward(tr.params, tr.cfg, torch.tensor([[5, 6]]),
                                 torch.zeros(1, 2, tr.cfg.n_embd), tr.new_mtp_cache(1, 16), 0)
    assert lg.shape == (1, 2, tr.cfg.n_vocab) and hid.shape == (1, 2, tr.cfg.n_embd)
    with pytest.raises(NotImplementedError, match="item 9"):
        TLM.forward(tr.params, tr.cfg, torch.tensor([[5, 6]]), tr.new_cache(1, 16), 0,
                    collect_stats=True)
