"""The BERT encoder family (bert, nomic-bert, jina-bert-v2) in the port
against the JAX package on the CPU.

Each variant's tiny fixture (2 layers, width 64, 4 heads, F16 linears, a
WPM vocabulary) goes through both packages' loaders and runtimes. The
loads are equal, array for array; the port's embeddings, in every pooling
mode, lie within TOL (1e-2) of the largest value of the JAX package's:
both round the float32 stream to bf16 before each linear, and a float32
difference in the last place of a LayerNorm output (the JAX runtime's is
jitted, and XLA fuses it) can move one element by a bf16 step (2^-8 of
it), which the layers carry on: 1.2e-4 of the largest state here, 1.7e-3
on the three-token input of test_torch_embed_server.py; without a flip
they agree to 3e-7. Padding a chunk to its bucket changes nothing, bit
for bit, and the attention is bidirectional."""
import numpy as np
import pytest
import torch
from torch import nn

import fixtures as F
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import bert as TB
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import bert_from_numpy
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from test_torch_archs import rewrite
from test_torch_llama import _numpy_tree

TOL = 1e-2
TEXT = "hello world the thing"


@pytest.fixture(scope="module", params=TB.ARCHS)
def model(request, tmp_path_factory):
    path = F.make_tiny_bert_gguf(tmp_path_factory.mktemp(request.param) / "b.gguf",
                                 variant=request.param, seed=3)
    return path, JG.Runtime.from_gguf(path), TG.Runtime.from_gguf(path, device="cpu")


def _numpy_pairs(p):
    """The JAX tree fetched to numpy, its (weight, bias) norm pairs kept as
    tuples (bert_from_numpy's input)."""
    if isinstance(p, tuple):
        return tuple(None if a is None else np.asarray(a) for a in p)
    if isinstance(p, dict):
        return {k: _numpy_pairs(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_numpy_pairs(v) for v in p]
    return _numpy_tree(p)


def _equal(a, b, where="params"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, nn.Module):
        ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
        assert ba.keys() == bb.keys(), where
        for k in ba:
            _equal(ba[k], bb[k], f"{where}.{k}")
    elif a is not None:
        assert a.dtype == b.dtype and torch.equal(a, b), where


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


def test_registered_and_loaded_as_jax(model):
    """The family runs its own forward on a NoCache, no longer among the
    architectures still to port, and the port's load equals the JAX
    package's carried over by bert_from_numpy."""
    _, jr, tr = model
    arch = tr.cfg.arch
    assert arch not in TG.OWN_FORWARD and TG.FORWARDS[arch] is TB.forward
    assert tr.encoder_only and isinstance(tr.new_cache(1, 64), TB.NoCache)
    _equal(bert_from_numpy(_numpy_pairs(jr.params), "cpu"), tr.params)
    blk = tr.params["blocks"][0]
    assert ("wqkv" in blk) == (arch == "nomic-bert")
    assert ("q_norm" in blk and "attn_norm_2" in blk) == (arch == "jina-bert-v2")


def test_loader_refuses_an_unknown_block_tensor(tmp_path):
    src = F.make_tiny_bert_gguf(tmp_path / "b.gguf")
    path = rewrite(src, tmp_path / "x.gguf",
                   extra={"blk.1.attn_unknown.weight": np.ones(64, np.float32)})
    tg = t_load_gguf(path)
    with pytest.raises(NotImplementedError, match="attn_unknown"):
        TB.load_bert_params(tg, t_config(tg.metadata), "cpu")


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", "none"])
def test_embeddings_match_jax(model, pooling):
    """Every pooling mode within TOL of the JAX runtime's embedding, and
    mean without normalization; a normalized vector has unit length."""
    _, jr, tr = model
    ids = tr.tokenizer.encode(TEXT)
    assert ids == jr.tokenizer.encode(TEXT)
    got, ref = tr.embed(ids, pooling), np.asarray(jr.embed(ids, pooling))
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= TOL
    if pooling != "none":
        assert abs(np.linalg.norm(got) - 1.0) < 1e-5
    if pooling == "mean":
        assert _rel(tr.embed(ids, pooling, normalize=False),
                    jr.embed(ids, pooling, normalize=False)) <= TOL


def test_padding_changes_nothing(model):
    """The live positions' states do not depend on what the padded ones
    hold: tokens past n_valid of zeros or of random ids give the same
    states bit for bit, and the embed path (padded to its bucket) gives
    the unpadded forward's within 1e-6."""
    _, _, tr = model
    ids = tr.tokenizer.encode(TEXT)
    n = len(ids)
    cache = tr.new_cache(1, 64)
    pad = torch.zeros((1, 16), dtype=torch.int64)
    pad[0, :n] = torch.tensor(ids)
    junk = pad.clone()
    junk[0, n:] = torch.from_numpy(np.random.default_rng(0).integers(5, 60, 16 - n))
    a = TB.forward(tr.params, tr.cfg, pad, cache, 0, n_valid=n)[0, :n]
    b = TB.forward(tr.params, tr.cfg, junk, cache, 0, n_valid=n)[0, :n]
    assert torch.equal(a, b)
    exact = TB.forward(tr.params, tr.cfg, torch.tensor([ids]), cache, 0)[0]
    assert _rel(tr.embed(ids, "none"), exact.numpy()) <= 1e-6


def test_attention_is_bidirectional(model):
    """The first position's state depends on the last token; the layer
    outputs' last layer is the embedding path's states, bit for bit."""
    _, _, tr = model
    a = tr.embed(tr.tokenizer.encode("hello world"), "none")
    b = tr.embed(tr.tokenizer.encode("hello thing"), "none")
    assert np.abs(a[0] - b[0]).max() > 1e-4
    hs = tr.layer_hiddens(tr.tokenizer.encode("hello world"))
    assert hs.shape == (tr.cfg.n_layer, len(a), tr.cfg.n_embd)
    np.testing.assert_array_equal(hs[-1].numpy(), a)
    with pytest.raises(NotImplementedError, match="encoder"):
        tr.eval_tokens([5, 6], tr.new_cache(1, 16), 0)
