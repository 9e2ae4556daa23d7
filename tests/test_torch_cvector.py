"""Control vectors in the port against the JAX package on the CPU: the GGUF
the port writes is the one the JAX writer writes, the dense steering array
loads the same, the forward adds it at each layer's output as the JAX one
does (the rule of test_torch_archs.py), the server's four
/control-vectors routes keep the JAX server's bookkeeping and apply the
JAX sum of the loaded vectors, and the generator (pca and mean) gives the
JAX generator's directions."""
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.runtime import cvector as JC
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.runtime import cvector as TC
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from ik_llama_cpp_tpu_torch.server.app import RequestError, Server
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine
from test_torch_archs import N_PROMPT, STEPS, TOL, forwards

N_LAYER, N_EMBD = 2, 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cvec")
    rng = np.random.default_rng(2)
    dirs = (rng.standard_normal((N_LAYER, N_EMBD)) * 0.5).astype(np.float32)
    dirs2 = (rng.standard_normal((N_LAYER, N_EMBD)) * 0.5).astype(np.float32)
    dirs2[0] = 0.0                                     # a layer it leaves alone
    return {"model": F.make_tiny_llama_gguf(d / "tiny.gguf", n_layer=N_LAYER),
            "a": TC.write_control_vector(d / "a.gguf", dirs),
            "b": TC.write_control_vector(d / "b.gguf", dirs2),
            "j": JC.write_control_vector(d / "j.gguf", dirs), "dirs": dirs}


def test_file_and_load_match_jax(files):
    assert files["a"].read_bytes() == files["j"].read_bytes()
    for kw in ({}, {"scale": -1.5}, {"layer_start": 1}, {"layer_end": 1}):
        np.testing.assert_array_equal(
            TC.load_control_vector(files["a"], N_LAYER, N_EMBD, **kw),
            JC.load_control_vector(files["j"], N_LAYER, N_EMBD, **kw))


def test_applied_vector_matches_jax_forward(files):
    jr = JRuntime.from_gguf(files["model"])
    tr = TRuntime.from_gguf(files["model"], device="cpu")
    ids = [int(x) for x in np.random.default_rng(0).integers(3, 250, N_PROMPT + STEPS)]
    jl0, tl0 = forwards(jr, tr, ids)
    cvec = TC.load_control_vector(files["a"], N_LAYER, N_EMBD, scale=2.0)
    JC.apply_control_vector(jr.params, cvec)
    TC.apply_control_vector(tr.params, cvec, tr.device)
    assert tr.params["cvec"].dtype == torch.float32
    jl, tl = forwards(jr, tr, ids)
    scale = float(np.abs(jl).max())
    assert np.abs(tl - jl).max() <= TOL * scale
    assert np.abs(tl - tl0).max() > 10 * TOL * scale       # the steering shows
    TC.remove_control_vector(tr.params)
    JC.remove_control_vector(jr.params)
    _, back = forwards(jr, tr, ids)
    np.testing.assert_array_equal(back, tl0)


def test_server_routes_keep_the_jax_bookkeeping(files):
    rt = TRuntime.from_gguf(files["model"], device="cpu")
    srv = Server(BatchEngine(rt, n_slots=1, capacity=64))
    assert srv.cvec_list() == [] and "cvec" not in rt.params
    assert srv.cvec_load({"path": str(files["a"])}) == {"success": True, "id": 0}
    assert srv.cvec_load({"path": str(files["b"]), "scale": 0.5,
                          "layer_start": 2}) == {"success": True, "id": 1}
    want = (JC.load_control_vector(files["a"], N_LAYER, N_EMBD)
            + JC.load_control_vector(files["b"], N_LAYER, N_EMBD, scale=0.5, layer_start=1))
    np.testing.assert_array_equal(rt.params["cvec"].numpy(), want)
    assert [cv["applied"] for cv in srv.cvec_list()] == [True, True]
    # apply: every scale to 0, then the given ones
    assert srv.cvec_apply([{"id": 1, "scale": -1.0, "layer_start": 1}]) == {"success": True}
    listed = srv.cvec_list()
    assert [(cv["scale"], cv["applied"]) for cv in listed] == [(0.0, False), (-1.0, True)]
    np.testing.assert_array_equal(
        rt.params["cvec"].numpy(), JC.load_control_vector(files["b"], N_LAYER, N_EMBD,
                                                          scale=-1.0))
    for bad in (lambda: srv.cvec_apply({"id": 5, "scale": 1.0}),
                lambda: srv.cvec_unload({"id": "0"}),
                lambda: srv.cvec_load({"path": str(files["a"]) + ".missing"})):
        with pytest.raises(RequestError) as e:
            bad()
        assert e.value.status == 400 and e.value.payload["success"] is False
    assert srv.cvec_list() == listed                 # a bad request changed nothing
    assert srv.cvec_unload({"id": 1}) == {"success": True}
    assert "cvec" not in rt.params and len(srv.cvec_list()) == 1


def test_routes_are_served():
    from ik_llama_cpp_tpu_torch.server.app import GET_ROUTES, POST_ROUTES
    assert GET_ROUTES["/control-vectors"] == "cvec_list"
    assert {POST_ROUTES[f"/control-vectors/{r}"] for r in ("load", "unload", "apply")} == {
        "cvec_load", "cvec_unload", "cvec_apply"}



POS = ["I love this, it is wonderful", "what a great day", "happy and kind"]
NEG = ["I hate this, it is awful", "what a dreadful day", "sad and cruel"]
COS_TOL = 0.999


@pytest.fixture(scope="module")
def runtimes(files):
    return JRuntime.from_gguf(files["model"]), TRuntime.from_gguf(files["model"], "cpu")


@pytest.mark.parametrize("method", ["pca", "mean"])
def test_generated_vector_matches_jax(runtimes, method):
    """generate_control_vector over three prompt pairs: unit directions,
    one a layer, each within COS_TOL (cosine 0.999) of the JAX generator's
    on the JAX runtime. The last token's layer outputs agree to the rule of
    test_torch_hidden.py (3%); their differences, which the generator takes,
    keep that absolute error, so a direction moves by well under a degree
    (observed cosines 0.99993 and above)."""
    jr, tr = runtimes
    ref = JC.generate_control_vector(jr, POS, NEG, method=method)
    got = TC.generate_control_vector(tr, POS, NEG, method=method)
    assert got.shape == ref.shape == (N_LAYER, N_EMBD) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    cos = (got * ref).sum(axis=1)
    assert (cos >= COS_TOL).all(), cos
