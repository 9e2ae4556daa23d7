"""LoRA adapters in the port against the JAX package on the CPU: the adapter
GGUF round trip, the runtime low-rank form (``LoraLinear``), scale and
strip, the F16 merge, the PEFT converter (``.bin`` and a ``.safetensors``
read by the port's own reader) and the server's ``/lora-adapters`` routes
and ``--lora`` flag.

Tolerances: the adapted eager forward within 1e-4 of the largest logit
(``test_torch_llama.py::test_forward_matches_jax_eager``'s), the adapted
runtime's all-position logits within 3e-2 of it
(``test_greedy_tokens_match_jax_runtime``'s: XLA's jit rounds the bf16
residual stream at other points); scale 0 and strip restore the base bit
for bit; the merged F16 bytes are the JAX merge's exactly."""
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.gguf.constants import GGMLType
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.quant.quantize import quantize as j_quantize
from ik_llama_cpp_tpu.runtime import lora as JLo
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.tools.convert_lora import convert_peft_dir as j_convert
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models import weights as TW
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.quant.quantize import quantize as t_quantize
from ik_llama_cpp_tpu_torch.runtime import lora as TLo
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from ik_llama_cpp_tpu_torch.server import app
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
from ik_llama_cpp_tpu_torch.tools.convert_lora import convert_peft_dir, read_safetensors
from test_torch_llama import _assert_same, _numpy_tree

RANK, ALPHA = 4, 8.0
PROJ = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def _tensors(cfg, names=PROJ, seed=3, head=True):
    """A rank-4 pair for every named projection of every layer (and the
    head): A (r, n_in), B (n_out, r), with each projection's widths."""
    rng = np.random.default_rng(seed)
    kv_dim = cfg.n_head_kv * cfg.head_dim
    dims = {"attn_q": (cfg.n_embd, cfg.n_embd), "attn_k": (cfg.n_embd, kv_dim),
            "attn_v": (cfg.n_embd, kv_dim), "attn_output": (cfg.n_embd, cfg.n_embd),
            "ffn_gate": (cfg.n_embd, cfg.n_ff), "ffn_up": (cfg.n_embd, cfg.n_ff),
            "ffn_down": (cfg.n_ff, cfg.n_embd)}
    out = {}
    for i in range(cfg.n_layer):
        for nm in names:
            k, n = dims[nm]
            out[f"blk.{i}.{nm}.weight"] = (
                (rng.standard_normal((RANK, k)) * 0.05).astype(np.float32),
                (rng.standard_normal((n, RANK)) * 0.05).astype(np.float32))
    if head:
        out["output.weight"] = ((rng.standard_normal((RANK, cfg.n_embd)) * 0.05).astype(
            np.float32), (rng.standard_normal((cfg.n_vocab, RANK)) * 0.05).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("tlora")
    model = make_tiny_llama_gguf(d / "base.gguf", seed=5)
    tr = TRuntime.from_gguf(model, device="cpu", fuse=False)
    adapter = TLo.write_lora_gguf(d / "adapter.gguf", "llama", ALPHA, _tensors(tr.cfg))
    return d, model, tr, adapter


IDS = [int(x) for x in np.random.default_rng(2).integers(3, 250, 21)]


def test_load_lora_gguf_equals_jax(base):
    """The port's load of an adapter the port wrote gives the JAX load's
    alpha, rank, names and arrays."""
    _, _, tr, path = base
    ta, ja = TLo.load_lora_gguf(path), JLo.load_lora_gguf(path)
    assert ta.alpha == ja.alpha == ALPHA and ta.rank == ja.rank == RANK
    assert ta.effective_scale() == ja.effective_scale() == ALPHA / RANK
    assert ta.tensors.keys() == ja.tensors.keys()
    assert len(ta.tensors) == 7 * tr.cfg.n_layer + 1
    for name, (a, b) in ta.tensors.items():
        assert np.array_equal(a, ja.tensors[name][0]) and np.array_equal(b, ja.tensors[name][1])


def _jax_numpy_tree(p):
    """_numpy_tree with the JAX package's LoraLinear as the port's tagged
    dict."""
    if isinstance(p, JW.LoraLinear):
        return {"type": "LoraLinear", "base": _jax_numpy_tree(p.base), "a": np.asarray(p.a),
                "b": np.asarray(p.b), "scale": np.asarray(p.scale)}
    if isinstance(p, dict):
        return {k: _jax_numpy_tree(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_jax_numpy_tree(v) for v in p]
    return _numpy_tree(p)


def test_adapted_params_and_forward_match_jax(base):
    """apply_lora in both packages on the unfused model: the JAX adapted
    tree carried over by params_from_numpy equals the port's own, and the
    eager forwards agree within 1e-4 of the largest logit, as unadapted."""
    _, model, tr, path = base
    jr = JRuntime.from_gguf(model, fuse=False)
    JLo.apply_lora(jr.params, JLo.load_lora_gguf(path))
    tp = TLo.apply_lora(TLM.load_llama_params(t_load_gguf(model), tr.cfg, "cpu"),
                        TLo.load_lora_gguf(path))
    assert isinstance(tp["output"], TW.LoraLinear)
    _assert_same(params_from_numpy(_jax_numpy_tree(jr.params), "cpu"), tp)
    toks = np.asarray(IDS[:16], np.int32)[None]
    jlog, _ = JLM.forward(jr.params, jr.cfg, jnp.asarray(toks),
                          JLM.KVCache.create(jr.cfg, 1, 256), jnp.int32(0))
    tlog = TLM.forward(tp, tr.cfg, torch.from_numpy(toks), TLM.KVCache.create(tr.cfg, 1, 256,
                                                                             "cpu"), 0)
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=1e-4 * np.abs(jlog).max())


def test_runtime_logits_match_jax_and_scale_0_and_strip_restore(base):
    """Adapted all_position_logits in both runtimes within 3e-2 of the
    largest logit; the adapter moves the port's logits; set_lora_scale(0)
    and strip_lora give the base logits bit for bit."""
    _, model, tr, path = base
    before = tr.all_position_logits(IDS, capacity=64)
    jr = JRuntime.from_gguf(model, fuse=False)
    ja = JLo.load_lora_gguf(path)
    JLo.apply_lora(jr.params, ja)
    jl = jr.all_position_logits(IDS, capacity=64)
    ta = TLo.load_lora_gguf(path)
    TLo.apply_lora(tr.params, ta)
    try:
        after = tr.all_position_logits(IDS, capacity=64)
        assert after.shape == (len(IDS), tr.cfg.n_vocab)
        assert float((after - before).abs().max()) > 1e-2 * float(before.abs().max())
        assert np.abs(after.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()
        scales = {id(m.scale) for m in tr.params["blocks"][0].values()
                  if isinstance(m, TW.LoraLinear)}
        TLo.set_lora_scale(tr.params, 0.0, ta)
        assert ta.scale == 0.0 and float(tr.params["output"].scale) == 0.0
        assert {id(m.scale) for m in tr.params["blocks"][0].values()
                if isinstance(m, TW.LoraLinear)} == scales        # written in place
        assert torch.equal(tr.all_position_logits(IDS, capacity=64), before)
        TLo.set_lora_scale(tr.params, 1.0, ta)
        assert torch.equal(tr.all_position_logits(IDS, capacity=64), after)
    finally:
        TLo.strip_lora(tr.params)
    assert not any(isinstance(v, TW.LoraLinear) for blk in tr.params["blocks"]
                   for v in blk.values())
    assert torch.equal(tr.all_position_logits(IDS, capacity=64), before)


def test_apply_lora_refuses_tensors_it_cannot_apply(base):
    """On the fused model attn_q has no linear: the JAX apply_lora skips
    it, the port's raises and leaves the model as it was."""
    d, model, _, _ = base
    tr = TRuntime.from_gguf(model, device="cpu", fuse=True)
    path = TLo.write_lora_gguf(d / "q.gguf", "llama", ALPHA,
                               _tensors(tr.cfg, ("attn_q", "ffn_down"), head=False))
    with pytest.raises(ValueError, match="fuse=False"):
        TLo.apply_lora(tr.params, TLo.load_lora_gguf(path))
    assert not any(isinstance(v, TW.LoraLinear) for blk in tr.params["blocks"]
                   for v in blk.values())
    jr = JRuntime.from_gguf(model, fuse=True)
    JLo.apply_lora(jr.params, JLo.load_lora_gguf(path))            # skipped in JAX
    assert isinstance(jr.params["blocks"][0]["ffn_down"], JW.LoraLinear)


def test_fuse_and_scale_refuse_a_lora_linear(base):
    _, model, _, path = base
    tp = TLo.apply_lora(TLM.load_llama_params(t_load_gguf(model), TRuntime.from_gguf(
        model, device="cpu").cfg, "cpu"), TLo.load_lora_gguf(path))
    blk = tp["blocks"][0]
    with pytest.raises(TypeError, match="LoraLinear"):
        TW.fuse_linears([blk["wq"], blk["wk"], blk["wv"]])
    with pytest.raises(TypeError, match="LoraLinear"):
        TW.scale_linear(blk["wo"], torch.tensor(2.0))


def test_float_encoders_equal_jax():
    x = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32) * 7
    for t in (GGMLType.F16, GGMLType.F32):
        assert np.array_equal(t_quantize(x, t), j_quantize(x, t)), t


def test_merge_lora_bytes_equal_jax(base):
    """merge_lora writes the adapted tensors as F16, byte for byte the JAX
    merge's, and copies the others."""
    d, model, _, path = base
    tm = t_load_gguf(TLo.merge_lora(model, path, d / "t_merged.gguf", scale=0.5))
    jm = t_load_gguf(JLo.merge_lora(model, path, d / "j_merged.gguf", scale=0.5))
    assert tm.tensors.keys() == jm.tensors.keys()
    assert tm.tensors["blk.0.attn_q.weight"].ggml_type == GGMLType.F16
    for name, info in tm.tensors.items():
        other = jm.tensors[name]
        assert info.ggml_type == other.ggml_type and info.shape == other.shape, name
        assert bytes(info.data) == bytes(other.data), name


def _write_safetensors(path, sd: dict) -> None:
    """A safetensors file: 8-byte little-endian header length, the JSON
    header, the raw little-endian data."""
    header, blobs, off = {}, [], 0
    for name, a in sd.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": {np.float32: "F32", np.float16: "F16"}[a.dtype.type],
                        "shape": list(a.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_convert_peft_dir_equals_jax(base, tmp_path):
    """A PEFT directory with a .bin converts to the JAX converter's adapter
    (every pair, alpha); the same weights in a .safetensors (F32 and F16
    tensors, read by the port's reader) give the same adapter."""
    _, _, tr, _ = base
    rng = np.random.default_rng(0)
    sd = {}
    for i in range(tr.cfg.n_layer):
        for mod in ("self_attn.q_proj", "mlp.down_proj"):
            k = tr.cfg.n_ff if mod == "mlp.down_proj" else tr.cfg.n_embd
            pre = f"base_model.model.model.layers.{i}.{mod}"
            sd[pre + ".lora_A.weight"] = rng.standard_normal((RANK, k)).astype(np.float16)
            sd[pre + ".lora_B.weight"] = rng.standard_normal((tr.cfg.n_embd, RANK)).astype(
                np.float32)
    sd["base_model.model.lm_head.lora_A.weight"] = rng.standard_normal(
        (RANK, tr.cfg.n_embd)).astype(np.float32)
    sd["base_model.model.lm_head.lora_B.weight"] = rng.standard_normal(
        (tr.cfg.n_vocab, RANK)).astype(np.float32)
    cfg = json.dumps({"lora_alpha": 16})
    pbin, pst = tmp_path / "bin", tmp_path / "st"
    for p in (pbin, pst):
        p.mkdir()
        (p / "adapter_config.json").write_text(cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pbin / "adapter_model.bin")
    _write_safetensors(pst / "adapter_model.safetensors", sd)
    assert all(np.array_equal(read_safetensors(pst / "adapter_model.safetensors")[k], v)
               for k, v in sd.items())
    mine = TLo.load_lora_gguf(convert_peft_dir(pbin, tmp_path / "t.gguf"))
    jax_ = TLo.load_lora_gguf(j_convert(pbin, tmp_path / "j.gguf"))
    st = TLo.load_lora_gguf(convert_peft_dir(pst, tmp_path / "s.gguf"))
    assert mine.alpha == jax_.alpha == st.alpha == 16.0
    assert mine.tensors.keys() == jax_.tensors.keys() == st.tensors.keys()
    assert len(mine.tensors) == 2 * tr.cfg.n_layer + 1 and "output.weight" in mine.tensors
    for name in mine.tensors:
        for x, y, z in zip(mine.tensors[name], jax_.tensors[name], st.tensors[name]):
            assert np.array_equal(x, y) and np.array_equal(x, z), name


def test_safetensors_reader_widens_bf16(tmp_path):
    """BF16 tensors are widened to float32 exactly (the upper 16 bits); a
    tensor that is not of a float type is refused."""
    x = np.asarray([1.5, -2.25, 3.0e-3, 7.0], np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)
    head = json.dumps({"t": {"dtype": "BF16", "shape": [2, 2], "data_offsets": [0, 8]},
                       "__metadata__": {"format": "pt"}}).encode()
    (tmp_path / "b.safetensors").write_bytes(struct.pack("<Q", len(head)) + head
                                             + bits.tobytes())
    got = read_safetensors(tmp_path / "b.safetensors")["t"]
    assert got.dtype == np.float32 and got.shape == (2, 2)
    assert np.array_equal(got.reshape(-1), (bits.astype(np.uint32) << 16).view(np.float32))
    head = json.dumps({"i": {"dtype": "I32", "shape": [1], "data_offsets": [0, 4]}}).encode()
    (tmp_path / "i.safetensors").write_bytes(struct.pack("<Q", len(head)) + head + bytes(4))
    with pytest.raises(ValueError, match="not a float type"):
        read_safetensors(tmp_path / "i.safetensors")


def test_lora_flag_and_routes(base):
    """--lora PATH[:SCALE] parsing; a Server with an adapter loaded as
    main() loads it lists it on GET /lora-adapters, POST sets its scale
    (and skips an id that names none), and at scale 0 a greedy completion
    of the same prompt is the base model's: the slot reuses none of the
    rows it cached under the adapter, as the reference server clears a
    slot's cached tokens when its LoRA set changes."""
    _, model, _, path = base
    assert app.parse_lora_arg(f"{path}:0.5") == (str(path), 0.5)
    assert app.parse_lora_arg(str(path)) == (str(path), 1.0)
    assert app.parse_lora_arg("C:/x/a.gguf") == ("C:/x/a.gguf", 1.0)
    args = app.parse_args(["--gguf", str(model), "--lora", f"{path}:0.5", "--lora", str(path)])
    assert args.lora == [f"{path}:0.5", str(path)]
    assert app.GET_ROUTES["/lora-adapters"] == "lora_list"
    assert app.POST_ROUTES["/lora-adapters"] == "lora_set"

    base_rt = TRuntime.from_gguf(model, device="cpu", fuse=False)
    rt = TRuntime.from_gguf(model, device="cpu", fuse=False)
    loras = app.load_loras(rt, [f"{path}:2"])
    assert loras[0].scale == 2.0 and isinstance(rt.params["blocks"][0]["wq"], TW.LoraLinear)
    want = rt.generate(IDS[:12], 6, stop_at_eos=False)[1]
    srv = app.Server(BatchEngine(rt, n_slots=1, capacity=128))
    srv.loras = loras
    srv.engine.start()
    try:
        assert srv.lora_list() == [{"id": 0, "path": str(path), "scale": 2.0}]
        body = {"prompt": IDS[:12], "n_predict": 6, "temperature": 0, "return_tokens": True}
        adapted = srv.completion(body)["tokens"]
        assert srv.lora_set([{"id": 0, "scale": 0.0}, {"id": 5, "scale": 3.0}]) == [
            {"id": 0, "path": str(path), "scale": 0.0}]
        cached = srv.engine.n_prompt_tokens_cached
        zero = srv.completion(body)["tokens"]
        assert srv.engine.n_prompt_tokens_cached == cached     # no row made at scale 2
    finally:
        srv.engine.stop()
    assert adapted == want
    assert zero == base_rt.generate(IDS[:12], 6, stop_at_eos=False)[1] != want
