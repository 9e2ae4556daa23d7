"""Runtime.reload_changed_tensors in the port (runtime/reload.py) against
the JAX package's on the CPU, on the tiny llama: a file that did not
change, or was only touched, reloads nothing; a whole new file of the same
shapes takes a full loader pass; one changed tensor with a leaf of its own
is re-encoded and copied into the live module in place, and one inside a
fused projection takes the full pass. Each time the port's logits equal a
fresh load of the new file bit for bit, and the JAX runtime's fresh load
of it within 2% of the largest logit (test_torch_archs.py's rule). The
JAX reload agrees but for ffn_up under a fused load: it swaps the fused
gate|up leaf for the lone up tensor, and its logits part from its own
fresh load's (shown below; ROADMAP.md section 3)."""
import os
import shutil

import numpy as np
import pytest
import torch

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from test_torch_archs import TOL

IDS = list(range(10, 26))


def _with_tensor(src, dst, name: str, seed: int):
    """src written to dst with the values of tensor ``name`` (F16 or F32 in
    the fixture) permuted by ``seed``, every other byte as it was."""
    m = load_gguf(src)
    w = GGUFWriter(str(dst))
    for key, val in m.metadata.items():
        w.add(key, val)
    for tname, info in m.tensors.items():
        data = info.data
        if tname == name:
            dtype = np.float16 if info.ggml_type.name == "F16" else np.float32
            data = np.random.default_rng(seed).permutation(
                np.frombuffer(bytes(data), dtype)).tobytes()
        w.add_tensor(tname, data, shape=info.shape, ggml_type=info.ggml_type)
    w.write()
    return dst


def _swap(path, new):
    """Replace path by new with a later mtime (the reload's first check)."""
    st = os.stat(path)
    shutil.copy(new, path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))


@pytest.fixture
def files(tmp_path):
    a = make_tiny_llama_gguf(tmp_path / "a.gguf", seed=1)
    live = tmp_path / "live.gguf"
    shutil.copy(a, live)
    return tmp_path, a, live


def _close(a, b) -> bool:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) <= TOL * float(np.abs(b).max())


def _check(live, rt, jr, jax_reload_right: bool = True):
    """The port's reloaded logits: a fresh port load's bit for bit and a
    fresh JAX load's within TOL; the JAX reload's held to its fresh load."""
    got = rt.all_position_logits(IDS)
    assert torch.equal(got, Runtime.from_gguf(live, "cpu").all_position_logits(IDS))
    want = np.asarray(JRuntime.from_gguf(live).all_position_logits(IDS))
    assert _close(got.numpy(), want)
    assert _close(np.asarray(jr.all_position_logits(IDS)), want) == jax_reload_right
    return got


def test_unchanged_and_touched_files_reload_nothing(files):
    _, _, live = files
    rt = Runtime.from_gguf(live, "cpu", track_reload=True)
    assert rt.reload_changed_tensors() is False
    st = os.stat(live)
    os.utime(live, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert rt.reload_changed_tensors() is False


def test_whole_file_takes_a_full_pass(files):
    d, _, live = files
    rt = Runtime.from_gguf(live, "cpu", track_reload=True)
    jr = JRuntime.from_gguf(live, track_reload=True)
    base = rt.all_position_logits(IDS)
    _swap(live, make_tiny_llama_gguf(d / "b.gguf", seed=2))
    assert rt.reload_changed_tensors() is True and jr.reload_changed_tensors() is True
    assert (_check(live, rt, jr) - base).abs().max() > 1e-3


@pytest.mark.parametrize("name,in_place", [("blk.0.ffn_down.weight", True),
                                           ("blk.1.attn_output.weight", True),
                                           ("output.weight", True),
                                           ("blk.0.ffn_up.weight", False),
                                           ("blk.1.attn_q.weight", False)])
def test_one_tensor(files, name, in_place):
    """A leaf of its own is patched in place (the module or tensor object
    kept, so every holder sees it); ffn_up and attn_q live inside the
    fused gate|up and q|k|v linears of a fused load, so they take the full
    pass."""
    d, a, live = files
    rt = Runtime.from_gguf(live, "cpu", track_reload=True)
    jr = JRuntime.from_gguf(live, track_reload=True)
    blocks = rt.params["blocks"]
    leaves = {"ffn_down": blocks[0]["ffn_down"], "wo": blocks[1]["wo"],
              "output": rt.params["output"]}
    _swap(live, _with_tensor(a, d / "c.gguf", name, 7))
    assert rt.reload_changed_tensors() is True and jr.reload_changed_tensors() is True
    _check(live, rt, jr, jax_reload_right=name != "blk.0.ffn_up.weight")
    kept = (rt.params["blocks"] is blocks
            and rt.params["blocks"][0]["ffn_down"] is leaves["ffn_down"]
            and rt.params["blocks"][1]["wo"] is leaves["wo"]
            and rt.params["output"] is leaves["output"])
    assert kept == in_place


def test_reload_requires_tracking(files):
    _, _, live = files
    with pytest.raises(RuntimeError, match="track_reload"):
        Runtime.from_gguf(live, "cpu").reload_changed_tensors()
