"""The device tools built on the hidden-state paths, in the port against the
JAX package's tools on the CPU: embedding (its normalizations and its
output), retrieval (chunking, ranking), gritlm (the instruction span left
out of the mean), cvector_generator (the file it writes) and lookahead,
and the CLI's --lookahead. Helpers that are pure numpy are held to the JAX
ones exactly; the tools' runs on the tiny fixtures end cleanly and print
what the JAX tools print, vectors within the rule of test_torch_bert.py
(1e-2 of the largest value)."""
import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.tools import embedding as JE
from ik_llama_cpp_tpu.tools import retrieval as JR
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.tools import cli, cvector_generator, embedding, gritlm
from ik_llama_cpp_tpu_torch.tools import lookahead as lookahead_tool
from ik_llama_cpp_tpu_torch.tools import retrieval

TOL = 1e-2


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    return {"bert": F.make_tiny_bert_gguf(d / "b.gguf", seed=5),
            "llama": F.make_tiny_llama_gguf(d / "l.gguf", seed=6)}


@pytest.mark.parametrize("p", [-1, 0, 2, 3])
def test_normalize_is_jax(p):
    v = np.random.default_rng(p + 2).standard_normal(17).astype(np.float32)
    np.testing.assert_array_equal(embedding.normalize(v, p), JE.normalize(v, p))


def test_embedding_tool(models, capsys):
    """Two prompts as JSON, then the plain rows with the similarity matrix:
    the JSON's vectors are the port's Runtime.embed's, normalized."""
    import json
    embedding.main(["-m", str(models["bert"]), "-p", "hello world", "-p", "the thing",
                    "--embd-output-format", "json", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    rt = Runtime.from_gguf(models["bert"], "cpu")
    ref = rt.embed(rt.tokenizer.encode("the thing"), "mean")
    assert len(out["data"]) == 2 and np.abs(np.asarray(out["data"][1]["embedding"]) - ref
                                            ).max() <= TOL * np.abs(ref).max()
    embedding.main(["-m", str(models["bert"]), "-p", "hello", "-p", "world", "--sim",
                    "--device", "cpu"])
    text = capsys.readouterr().out
    assert "embedding 1:" in text and "cosine similarity matrix" in text


def test_retrieval_tool(models, tmp_path, capsys):
    """chunk_file and rank are the JAX tool's; a query's best chunk is
    printed first."""
    doc = tmp_path / "doc.txt"
    doc.write_text("hello world\nthe thing\nworld of things\nhello there\n" * 3)
    a, b = retrieval.chunk_file(str(doc), 20, "\n"), JR.chunk_file(str(doc), 20, "\n")
    assert [(c.pos, c.text) for c in a] == [(c.pos, c.text) for c in b]
    emb = np.random.default_rng(0).standard_normal((len(a), 8)).astype(np.float32)
    q = emb[1] + 0.1
    assert retrieval.rank(emb, q, 3) == JR.rank(emb, q, 3)
    retrieval.main(["-m", str(models["bert"]), "--context-file", str(doc), "--chunk-size", "20",
                    "--query", "hello world", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("[")


def test_gritlm_leaves_the_instruction_out(models, capsys):
    """The embedding is the mean over the sample's span alone, normalized;
    the tool prints four similarities and a generation."""
    rt = Runtime.from_gguf(models["llama"], "cpu")
    prefix = rt.tokenizer.encode(gritlm.gritlm_instruction("find it"))
    ids = prefix + rt.tokenizer.encode("a sample", add_bos=False)
    ref = rt.embed(ids, "none")[len(prefix):].mean(axis=0)
    got = gritlm.encode_gritlm(rt, "a sample", "find it")
    np.testing.assert_allclose(got, ref / np.linalg.norm(ref), rtol=0, atol=1e-6)
    gritlm.main(["-m", str(models["llama"]), "-n", "4", "--device", "cpu"])
    assert capsys.readouterr().out.count("Cosine similarity") == 4


def test_cvector_generator_tool(models, tmp_path, capsys):
    """The tool writes one unit direction a layer, 1-indexed."""
    (tmp_path / "p.txt").write_text("happy day\nkind words\n")
    (tmp_path / "n.txt").write_text("sad day\ncruel words\n")
    out = tmp_path / "cv.gguf"
    cvector_generator.main(["-m", str(models["llama"]), "--positive-file",
                            str(tmp_path / "p.txt"), "--negative-file", str(tmp_path / "n.txt"),
                            "-o", str(out), "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    g = load_gguf(out)
    assert g.metadata["general.architecture"] == "controlvector"
    assert sorted(g.tensors) == ["direction.1", "direction.2"]


def test_lookahead_tool_and_cli(models, capsys):
    """tools/lookahead and cli --lookahead decode greedily and report their
    rounds."""
    lookahead_tool.main(["-m", str(models["llama"]), "-p", "hello hello", "-n", "6",
                         "-W", "3", "-N", "3", "-G", "2", "--device", "cpu"])
    assert "rounds =" in capsys.readouterr().err
    cli.main(["-m", str(models["llama"]), "-p", "hello hello", "-n", "6", "--temp", "0",
              "--lookahead", "--device", "cpu"])
    assert "[lookahead: 6 tokens" in capsys.readouterr().err
