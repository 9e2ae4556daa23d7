"""``moe_ffn`` of the port against the JAX package over every expert form:
all-planar (group 32, bf16 scales), mixed (gate/up re-coded per supergroup
of 256 with f32 scales, down planar), and bf16 ``ExpertWeights``; with the
options ``weight_before_ffn``, ``expert_out_scale`` and ``selection_bias``;
at T = 1 and 8 (the decode chains) and 64 (the sorted prefill). Both
packages route, quantize and round at the same points; a float32 sum taken
in another order can move an h across a bf16 boundary or an int8 step: 1%
of the largest output, the tolerance of the int8-expert ``moe_ffn`` test."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import moe as JM
from ik_llama_cpp_tpu_torch.models.convert import params_from_numpy
from ik_llama_cpp_tpu_torch.ops import moe as TM

from test_torch_moe_planar import experts_np, to_jax, to_torch

G, E, FF, TOPK = 8, 256, 96, 2
FORMS = {"planar": ((32, 32, 32), ("bf16", "bf16", "bf16")),
         "mixed": ((256, 256, 32), ("f32", "f32", "bf16")),
         "supergroup-gate-only": ((256, 32, 32), ("f32", "bf16", "bf16"))}


def dense_np(seed, bias=False):
    rng = np.random.default_rng(seed)
    d = {"type": "ExpertWeights"}
    for name, (k, n) in (("gate", (E, FF)), ("up", (E, FF)), ("down", (FF, E))):
        w = (rng.standard_normal((G, k, n)) / np.sqrt(k)).astype(np.float32)
        d[name] = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        d[name + "_b"] = rng.standard_normal((G, n)).astype(np.float32) if bias else None
    return d


def dense_jax(d):
    return JM.ExpertWeights(*(jnp.asarray(d[n], jnp.bfloat16) for n in ("gate", "up", "down")),
                            *(None if d[n + "_b"] is None else jnp.asarray(d[n + "_b"])
                              for n in ("gate", "up", "down")))


def dense_torch(d):
    return TM.ExpertWeights(*(torch.from_numpy(d[n]).to(torch.bfloat16)
                              for n in ("gate", "up", "down")),
                            *(None if d[n + "_b"] is None else torch.from_numpy(d[n + "_b"])
                              for n in ("gate", "up", "down")))


def both(form, seed, bias=False):
    if form == "bf16":
        d = dense_np(seed, bias)
        return dense_torch(d), dense_jax(d)
    d = experts_np(G, E, FF, *FORMS[form], seed=seed, bias=bias)
    return to_torch(d), to_jax(d)


def run_both(form, t, seed, bias=False, **kw):
    rng = np.random.default_rng(100 * t + seed)
    te, je = both(form, seed, bias)
    x = (rng.standard_normal((t, E)) * 0.5).astype(np.float32)
    logits = rng.standard_normal((t, G)).astype(np.float32)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = TM.moe_ffn(torch.from_numpy(x), torch.from_numpy(logits), te, TOPK, **tkw).numpy()
    ref = np.asarray(JM.moe_ffn(jnp.asarray(x), jnp.asarray(logits), je, TOPK, **jkw))
    assert got.shape == ref.shape == (t, E)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("form", ["planar", "mixed", "supergroup-gate-only", "bf16"])
def test_moe_ffn_forms_match_jax(form, t):
    """'supergroup-gate-only' has gate and up of different groups, which
    keeps even T <= 8 off the decode chains in both packages."""
    run_both(form, t, seed=1, norm_topk=True)


@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("form", ["planar", "mixed", "bf16"])
def test_moe_ffn_weight_before_ffn(form, t):
    run_both(form, t, seed=2, gating=JM.GATING_SIGMOID, weight_before_ffn=True)


@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("form", ["planar", "mixed", "bf16"])
def test_moe_ffn_biases_scale_and_selection_bias(form, t):
    rng = np.random.default_rng(9)
    run_both(form, t, seed=3, bias=True, activation="swiglu_oai", gating=JM.GATING_SIGMOID,
             norm_topk=True, scale=2.5,
             selection_bias=rng.standard_normal(G).astype(np.float32),
             expert_out_scale=(rng.random(G) + 0.5).astype(np.float32))


def test_moe_ffn_act_limit():
    run_both("mixed", 8, seed=4, act_limit=0.3)
    run_both("planar", 64, seed=4, act_limit=0.3)


def _same(a, b):
    assert type(a) is type(b)
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.stride() == y.stride() and torch.equal(x, y), f
        else:
            assert x == y, f


@pytest.mark.parametrize("form", ["planar", "mixed", "bf16"])
def test_params_from_numpy_round_trip(form):
    """A JAX expert set fetched to numpy and carried over equals the one
    built directly: codes held as the (G, K, N) view of a (G, N, K) tensor,
    supergroup scales f32, planar scales bf16, bf16 dense experts."""
    te, je = both(form, seed=5, bias=True)
    d = {"type": type(je).__name__}
    for n in ("gate", "up", "down"):
        d[n] = np.asarray(getattr(je, n))
        d[n + "_b"] = np.asarray(getattr(je, n + "_b"))
        if form != "bf16":
            d[n + "_s"] = np.asarray(getattr(je, n + "_s"))
            d[n + "_group"] = getattr(je, n + "_group")
    _same(params_from_numpy({"experts": d}, "cpu")["experts"], te)
