"""The port's state files (``runtime/state.py``) against the JAX package's,
and the engine's slot save / erase / restore on the CPU.

Every comparison here is exact: rows are compared bit for bit (bf16 as
its 16-bit words), files byte for byte, and greedy tokens equal."""
import dataclasses
import queue

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.models.llama import KVCache as JKVCache
from ik_llama_cpp_tpu.runtime import state as jstate
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine, Request as JRequest
from ik_llama_cpp_tpu_torch.models.bert import NoCache
from ik_llama_cpp_tpu_torch.models.llama import KVCache, MixedKVCache, SwaKVCache
from ik_llama_cpp_tpu_torch.models.mamba import MambaCache
from ik_llama_cpp_tpu_torch.models.qwen3next import HybridCache
from ik_llama_cpp_tpu_torch.runtime import state
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, SlotState

SHAPE = (2, 1, 16, 2, 8)        # L, B, S, Hkv, D
N_PAST = 5


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("state") / "m.gguf", seed=1)


@pytest.fixture(scope="module")
def rt(model):
    return Runtime.from_gguf(model, device="cpu")


def _cache(codec: str, seed: int = 0) -> KVCache:
    """A port cache of random contents: bf16 rows, or q8 / q4 codes with
    their float32 scales."""
    g = torch.Generator().manual_seed(seed)
    if codec == "bf16":
        return KVCache(*(torch.randn(SHAPE, generator=g).to(torch.bfloat16) for _ in "kv"))
    width, dt = {"q8": (8, torch.int8), "q4": (4, torch.uint8)}[codec]
    lo, hi = (-128, 128) if dt == torch.int8 else (0, 256)
    codes = [torch.randint(lo, hi, SHAPE[:-1] + (width,), generator=g, dtype=dt)
             for _ in "kv"]
    scales = [torch.rand(SHAPE[:-1], generator=g) for _ in "kv"]
    return KVCache(*codes, *scales)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _fields(kv) -> list:
    return [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.k_scale is not None else [])


def _to_jax(kv: KVCache) -> JKVCache:
    arrs = [jnp.asarray(_bits(t).view(ml_dtypes.bfloat16)) if t.dtype == torch.bfloat16
            else jnp.asarray(t.numpy()) for t in _fields(kv)]
    return JKVCache(*arrs) if len(arrs) == 4 else JKVCache(arrs[0], arrs[1])


@pytest.mark.parametrize("codec", ["bf16", "q8", "q4"])
def test_round_trip(tmp_path, codec):
    """Rows [0, n_past) come back bit for bit; the rows above stay as the
    destination had them; the returned size is the file's."""
    src, dst = _cache(codec, 0), _cache(codec, 1)
    keep = [_bits(t.clone())[:, :, N_PAST:] for t in _fields(dst)]
    path = tmp_path / "s.bin"
    size = state.save_state(path, list(range(10, 10 + N_PAST)), N_PAST, src)
    assert size == path.stat().st_size
    toks, n, out = state.load_state(path, dst)
    assert toks == list(range(10, 10 + N_PAST)) and n == N_PAST and out is dst
    for a, b, hi in zip(_fields(src), _fields(dst), keep):
        np.testing.assert_array_equal(_bits(a)[:, :, :N_PAST], _bits(b)[:, :, :N_PAST])
        np.testing.assert_array_equal(_bits(b)[:, :, N_PAST:], hi)


@pytest.mark.parametrize("codec", ["bf16", "q8"])
def test_files_cross_packages(tmp_path, codec):
    """The two packages write the same bytes for the same state, and each
    reads the other's file to the same rows, bit for bit."""
    kv = _cache(codec, 2)
    toks = [3, 1, 4, 1, 5]
    state.save_state(tmp_path / "port.bin", toks, N_PAST, kv)
    jstate.save_state(tmp_path / "jax.bin", toks, N_PAST, _to_jax(kv))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    jt, jn, jkv = jstate.load_state(tmp_path / "port.bin", _to_jax(_cache(codec, 3)))
    assert (jt, jn) == (toks, N_PAST)
    for a, b in zip(_fields(kv), [jkv.k, jkv.v, jkv.k_scale, jkv.v_scale]):
        np.testing.assert_array_equal(_bits(a)[:, :, :N_PAST], _jax_bits(b)[:, :, :N_PAST])
    tkv = _cache(codec, 4)
    assert state.load_state(tmp_path / "jax.bin", tkv)[:2] == (toks, N_PAST)
    for a, b in zip(_fields(kv), _fields(tkv)):
        np.testing.assert_array_equal(_bits(a)[:, :, :N_PAST], _bits(b)[:, :, :N_PAST])


def test_read_state_meta(tmp_path):
    state.save_state(tmp_path / "a.bin", [7, 8, 9], 3, _cache("bf16"), rows_exact=True)
    jstate.save_state(tmp_path / "j.bin", [7, 8, 9], 3, _to_jax(_cache("bf16")))
    meta = state.read_state_meta(tmp_path / "a.bin")
    assert meta == {"tokens": [7, 8, 9], "n_past": 3, "quantized": False,
                    "k_dtype": "bfloat16", "capacity": SHAPE[2], "rows_exact": True}
    jmeta = state.read_state_meta(tmp_path / "j.bin")
    assert jmeta == jstate.read_state_meta(tmp_path / "j.bin")
    assert {**jmeta, "rows_exact": True} == meta
    assert state.restored_tokens(meta) == [7, 8, 9]
    assert state.restored_tokens(jmeta) == [7, 8]     # the JAX engine's last row is unwritten
    (tmp_path / "x.bin").write_bytes(b"not a state file")
    assert state.read_state_meta(tmp_path / "x.bin") is None
    assert state.read_state_meta(tmp_path / "missing.bin") is None
    with pytest.raises(ValueError, match="not a state file"):
        state.load_state(tmp_path / "x.bin", _cache("bf16"))
    with pytest.raises(ValueError, match="quantized"):
        state.load_state(tmp_path / "a.bin", _cache("q8"))


def _dummy(cls):
    """An instance of a cache class, its fields unset: the refusal looks at
    the type alone."""
    return object.__new__(cls)


@pytest.mark.parametrize("make,name", [
    (lambda: _dummy(MixedKVCache), "MixedKVCache"), (lambda: _dummy(SwaKVCache), "SwaKVCache"),
    (lambda: _dummy(HybridCache), "HybridCache"), (lambda: _dummy(MambaCache), "MambaCache"),
    (lambda: NoCache(torch.device("cpu")), "NoCache"),
    (lambda: KVCache(torch.zeros(SHAPE, dtype=torch.bfloat16), None), "MLA latent")],
    ids=["mixed", "swa", "hybrid", "mamba", "nocache", "mla"])
def test_other_caches_refused(tmp_path, make, name):
    kv = make()
    with pytest.raises(TypeError, match=name):
        state.save_state(tmp_path / "s.bin", [1], 1, kv)
    state.save_state(tmp_path / "ok.bin", [1], 1, _cache("bf16"))
    with pytest.raises(TypeError, match=name):
        state.load_state(tmp_path / "ok.bin", kv)


def _serve(eng, prompt, n=8):
    r = Request(prompt_ids=list(prompt), n_predict=n, sampler=SamplerParams(temp=0.0),
                stream_queue=queue.Queue())
    eng.submit(r)
    toks = []
    while True:
        tok, _, done = r.stream_queue.get(timeout=120)
        toks += [tok] if tok >= 0 else []
        if done:
            assert r.error is None
            return toks


@pytest.mark.parametrize("kv_quant", [False, "q8"])
def test_engine_save_erase_overwrite_restore(tmp_path, rt, kv_quant):
    """A slot saved, erased, overwritten by another prompt and restored
    holds the saved rows bit for bit, counts them as cached, and gives the
    greedy tokens of a slot that was never interrupted. A busy slot takes
    no restore."""
    rtq = dataclasses.replace(rt, kv_quant=kv_quant)
    tok = rt.tokenizer
    a = tok.encode("Once upon a time there was")
    b = tok.encode("the quick brown fox jumps")
    eng = BatchEngine(rtq, n_slots=1, capacity=128)
    eng.start()
    try:
        gen_a = _serve(eng, a)
        saved = eng.save_slot(0, str(tmp_path / "slot0.bin"))
        assert saved["n_saved"] == len(a) + len(gen_a) - 1 == len(eng.slots[0].cache_tokens)
        rows = [_bits(t[:, 0, :saved["n_saved"]].clone()) for t in _fields(eng.kv)]
        assert eng.erase_slot(0)["n_erased"] == saved["n_saved"]
        _serve(eng, b, 12)
        r = eng.restore_slot(0, str(tmp_path / "slot0.bin"))
        assert r["n_restored"] == saved["n_saved"]
        for want, t in zip(rows, _fields(eng.kv)):
            np.testing.assert_array_equal(_bits(t[:, 0, :saved["n_saved"]]), want)
        ext = a + gen_a + tok.encode(" and")
        cached0 = eng.n_prompt_tokens_cached
        got = _serve(eng, ext)
        assert eng.n_prompt_tokens_cached - cached0 == saved["n_saved"]
    finally:
        eng.stop()
    ref = BatchEngine(rtq, n_slots=1, capacity=128)
    ref.start()
    try:
        assert _serve(ref, a) == gen_a
        assert _serve(ref, ext) == got
    finally:
        ref.stop()
    busy = BatchEngine(rtq, n_slots=1, capacity=128)
    busy.submit(Request(prompt_ids=a, n_predict=4, sampler=SamplerParams(temp=0.0)))
    busy.step()
    assert busy.slots[0].state != SlotState.IDLE
    with pytest.raises(ValueError, match="busy"):
        busy.restore_slot(0, str(tmp_path / "slot0.bin"))


def test_jax_engine_slot_file(tmp_path, model, rt):
    """A slot file of the JAX engine restores into the port's engine with
    its tokens less the last, whose row the JAX engine never wrote; its
    rows are the file's bit for bit, and the port serves on from them."""
    jrt = JRuntime.from_gguf(model)
    p = rt.tokenizer.encode("Hello world")
    jeng = JEngine(jrt, n_slots=1, capacity=128)
    r = JRequest(prompt_ids=p, n_predict=6, sampler=JParams(temp=0.0),
                 stream_queue=queue.Queue())
    jeng.submit(r)
    jeng.start()
    try:
        while not r.stream_queue.get(timeout=120)[2]:
            pass
        jeng.save_slot(0, str(tmp_path / "j.bin"))
        jtoks = list(jeng.slots[0].cache_tokens)
    finally:
        jeng.stop()
    eng = BatchEngine(rt, n_slots=1, capacity=128)
    out = eng.restore_slot(0, str(tmp_path / "j.bin"))
    assert eng.slots[0].cache_tokens == jtoks[:-1] and out["n_restored"] == len(jtoks) - 1
    _, _, jkv = jstate.load_state(tmp_path / "j.bin", jeng._slot_row(0))
    n = len(jtoks) - 1
    for a, b in zip(_fields(eng.kv), [jkv.k, jkv.v]):
        np.testing.assert_array_equal(_bits(a[:, 0, :n]), _jax_bits(b)[:, 0, :n])
    eng.start()
    try:
        assert len(_serve(eng, jtoks + [5], 4)) == 4
        assert eng.n_prompt_tokens_cached == n
    finally:
        eng.stop()


def test_slot_commands_beside_many_clients(tmp_path, rt):
    """Eight client threads serve requests on two slots while two more
    save and erase slot 1 and restore it when idle, with a short switch
    interval: every request completes with its greedy tokens, every save
    is a state file, and no command raced a forward (no failed request)."""
    import sys
    import threading
    eng = BatchEngine(rt, n_slots=2, capacity=128)
    eng.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    out, errs = {}, []

    def client(i):
        out[i] = _serve(eng, [1, 30 + i, 40 + i], 4)

    def slotter(k):
        for j in range(6):
            try:
                f = str(tmp_path / f"s{k}_{j}.bin")
                eng.save_slot(1, f)
                assert state.read_state_meta(f) is not None
                eng.erase_slot(1)
                eng.restore_slot(1, f)
            except ValueError as e:           # a busy slot takes no restore
                assert "busy" in str(e)
            except Exception as e:            # noqa: BLE001 - reported below
                errs.append(e)

    threads = ([threading.Thread(target=client, args=(i,)) for i in range(8)]
               + [threading.Thread(target=slotter, args=(k,)) for k in range(2)])
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert not errs and eng.n_failed == 0
    assert sorted(out) == list(range(8)) and all(len(v) == 4 for v in out.values())
    ref = BatchEngine(rt, n_slots=1, capacity=128)
    ref.start()
    try:
        assert _serve(ref, [1, 33, 43], 4) == out[3]
    finally:
        ref.stop()
