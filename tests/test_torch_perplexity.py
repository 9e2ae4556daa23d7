"""The perplexity tool in the port against the JAX package's on the CPU:
``compute_perplexity``, ``save_logits`` / ``kl_divergence`` and
``hellaswag_score`` over ``Runtime.all_position_logits``, on the tiny
llama and the tiny mamba fixtures. On the llama the JAX runtime runs with
jit disabled, whose forward the port's follows to 1e-4 of the largest
logit (test_torch_llama.py; observed 1.7e-7 here): its perplexity agrees
to 1e-4 of its value. The KLD run's chunks (tokenized without BOS) meet a
bf16 flip of the residual stream in one chunk: its statistics are held to
1e-3 absolute and its perplexities to 1e-3 of their value. The mamba
model and HellaSwag run through the jitted JAX runtime (its eager mamba
steps the scan in Python, ~20 s a chunk here), which rounds the residual
stream at other points: the mamba perplexity is held to 1e-2 of its
value (observed 2.9e-3; the eager forwards are held tighter in
test_torch_mamba.py), HellaSwag's pick is the same (its length-normalized
scores lie ~0.9 apart)."""
import jax
import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.tools import perplexity as JP
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from ik_llama_cpp_tpu_torch.tools import perplexity as TP

TEXT = ("the quick brown fox jumps over the lazy dog while the cat sleeps on a warm "
        "mat near the door of an old house by the river, and the birds sing in the "
        "tall trees as the morning light falls across the fields of green grass ")
N_CTX = 64
REL = {"llama": 1e-4, "mamba": 1e-2}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    return {"llama": F.make_tiny_llama_gguf(d / "llama.gguf", seed=5),
            "mamba": F.make_tiny_mamba_gguf(d / "mamba.gguf", seed=9)}


@pytest.fixture(scope="module")
def rts(models):
    return {k: (JRuntime.from_gguf(p), TRuntime.from_gguf(p, device="cpu"))
            for k, p in models.items()}


@pytest.mark.parametrize("name", ["llama", "mamba"])
def test_compute_perplexity_equals_jax(rts, name):
    jr, tr = rts[name]
    if name == "llama":
        with jax.disable_jit():
            jp, je, jn = JP.compute_perplexity(jr, TEXT, n_ctx=N_CTX, verbose=False)
    else:
        jp, je, jn = JP.compute_perplexity(jr, TEXT, n_ctx=N_CTX, verbose=False)
    tp, te, tn = TP.compute_perplexity(tr, TEXT, n_ctx=N_CTX, verbose=False)
    assert tn == jn == (len(tr.tokenizer.encode(TEXT, parse_special=False)) // N_CTX) * (
        N_CTX // 2 - 1)
    assert abs(tp - jp) <= REL[name] * jp and abs(te - je) <= 10 * REL[name] * je
    assert np.isfinite(tp) and tp > 1.0


def test_short_text_is_refused(rts):
    with pytest.raises(ValueError, match="too short"):
        TP.compute_perplexity(rts["llama"][1], "tiny", n_ctx=N_CTX, verbose=False)


def test_save_logits_and_kl_divergence_equal_jax(rts, tmp_path):
    """Each package saves base logits of the same chunks; the port's KLD
    statistics against the JAX file equal the JAX tool's against it, and
    the port's model against its own float16 file gives KLD under 1e-5, the
    same top token but where float16 ties a pair, and equal perplexities."""
    jr, tr = rts["llama"]
    with jax.disable_jit():
        JP.save_logits(jr, TEXT, str(tmp_path / "j.npz"), n_ctx=N_CTX)
        jres = JP.kl_divergence(jr, str(tmp_path / "j.npz"), verbose=False)
    TP.save_logits(tr, TEXT, str(tmp_path / "t.npz"), n_ctx=N_CTX)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert int(t["n_ctx"]) == N_CTX and np.array_equal(t["chunks"], j["chunks"])
    assert t["logits"].dtype == np.float16 and t["logits"].shape == j["logits"].shape
    # a bf16 rounding flip of the residual stream in one of the chunks moves
    # its logits by up to 2^-8 of a value (observed 5.2e-3 of the largest)
    lj = j["logits"].astype(np.float32)
    assert np.abs(t["logits"].astype(np.float32) - lj).max() <= 2 ** -5 * np.abs(lj).max()
    tres = TP.kl_divergence(tr, str(tmp_path / "j.npz"), verbose=False)
    assert tres.keys() == jres.keys()
    for k in ("kld_mean", "kld_max", "kld_p99"):     # observed: 4.3e-4 at the max
        assert abs(tres[k] - jres[k]) <= 1e-3, k
    assert abs(tres["same_top_p"] - jres["same_top_p"]) <= 1.0 / 31
    for k in ("ppl_ours", "ppl_base"):               # observed: 7.2e-4 (ppl_ours)
        assert abs(tres[k] - jres[k]) <= 1e-3 * jres[k], k
    own = TP.kl_divergence(tr, str(tmp_path / "t.npz"), verbose=False)
    # the float16 file ties a top pair now and then (observed: 1 position of 217)
    assert own["same_top_p"] >= 0.99 and own["kld_max"] <= 1e-5
    assert abs(own["ppl_ours"] - own["ppl_base"]) <= 1e-3 * own["ppl_base"]


def test_hellaswag_score_equals_jax(rts):
    tasks = [{"query": "the cat sat on the", "choices": ["mat", "dog ran", "blue sky",
                                                          "river of stone"], "gold": 0}]
    jr, tr = rts["llama"]
    assert TP.hellaswag_score(tr, tasks, verbose=False) == JP.hellaswag_score(
        jr, tasks, verbose=False) == 100.0


def test_main_takes_device(models, tmp_path, capsys):
    text = tmp_path / "t.txt"
    text.write_text(TEXT)
    ppl = TP.main(["--gguf", str(models["llama"]), "--text", str(text), "--n-ctx",
                   str(N_CTX), "--device", "cpu"])
    assert "Final estimate: PPL = " in capsys.readouterr().out and ppl > 1.0
